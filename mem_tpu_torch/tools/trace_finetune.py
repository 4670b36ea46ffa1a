"""Trace the classification finetune train step (ft_vit, mixup + EMA) on the
card and print where its device time goes.

Port of scripts/trace_finetune.py. On the card, from the repo root::

    python -m mem_tpu_torch.tools.trace_finetune [B=128] [steps=3] [mae=0|1]
        [fa=0|1] [flat=0|1] [fused_mlp=0|1] [dir=<trace dir>] [device=cuda|cpu]

The reference's step (``ft_vit`` bf16, 101 classes, init_values 0.1, the
shared rel-pos bias, drop-path 0.1, mean pooling; ``mae=1``: the ``--MAE 1``
model, ``vit_base_patch16`` with the global pool), one micro-batch of B=128
samples of 30,000 events from ``np.random.default_rng(0)``, RandAugment with
batch ops, mixup 0.8 / cutmix 1.0 (prob 1, switch 0.5, smoothing 0.1), EMA
0.9999, the cosine schedule 4e-3 -> 1e-6 with layer decay 0.9 over 12
blocks, through ``train.steps.make_finetune_train_step``: two warm-up steps,
then ``steps`` traced steps, each with the augmentation and mixup draws of
``aug_seed`` + 1, + 2, ... made on the host before the window.
``step_timers.analyze`` prints the breakdown. ``flat=0`` sends the
attention to K5a / K5c, ``fused_mlp=1`` the MLPs to K6f / K6b. Runs on the
card unless ``device=cpu``; exits 2 without one.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from mem_tpu_torch.tools.step_timers import (gpu_name, parse_args, refuse, resolved, toggles,
                                             trace_train)


def config(B=128, N=30000, num_classes=101, mae=False) -> dict:
    """What :func:`build` builds, as plain values (trace_finetune.py:28-75):
    the model's registry name and keyword arguments, the host batch (one
    micro-batch on the leading axis), the preprocessing, the lr schedule,
    the optimizer's, the mixup's and the step's settings."""
    from mem_tpu_torch.data.device_pipeline import PreprocConfig
    from mem_tpu_torch.train.schedules import cosine_scheduler

    if mae:
        model = ("vit_base_patch16", dict(num_classes=num_classes, img_size=(224, 224),
                                          in_chans=3, drop_path_rate=0.1, global_pool=True,
                                          dtype="bfloat16"))
    else:
        model = ("ft_vit", dict(num_classes=num_classes, dtype="bfloat16", init_values=0.1,
                                use_shared_rel_pos_bias=True, drop_path_rate=0.1,
                                use_mean_pooling=True))
    rng = np.random.default_rng(0)
    batch = {
        "events": rng.random((1, B, N, 4)).astype(np.float32) * [240, 180, 1e6, 1],
        "n_valid": np.full((1, B), N, np.int32),
        "label": rng.integers(0, num_classes, (1, B)).astype(np.int64),
        "sample_h": np.full((1, B), 180, np.int32),
        "sample_w": np.full((1, B), 240, np.int32),
        "time_flip": rng.random((1, B)) < 0.5,
        "x_flip": rng.random((1, B)) < 0.5,
        "shift_xy": rng.integers(-8, 9, (1, B, 2)).astype(np.int32),
        "aug_seed": np.arange(B, dtype=np.uint32)[None],
    }
    batch["events"][..., 3] = rng.choice([-1.0, 1.0], (1, B, N))
    return dict(
        model=model, batch=batch,
        preproc=PreprocConfig(canvas_h=256, canvas_w=256, rand_aug=True,
                              rand_aug_batch_ops=True, color_jitter=0.0),
        lr=cosine_scheduler(4e-3, 1e-6, 10, 100, warmup_steps=10),
        optimizer=dict(weight_decay=0.05, layer_decay=0.9, num_layers=12),
        mixup=dict(num_classes=num_classes, mixup_alpha=0.8, cutmix_alpha=1.0, prob=1.0,
                   switch_prob=0.5, label_smoothing=0.1),
        step=dict(num_classes=num_classes, smoothing=0.1, update_freq=1, ema_decay=0.9999))


def build(cfg, device, model_kw=None):
    """(step, model, mixup settings) of ``cfg`` on ``device``, weights drawn
    from seed 0, the EMA starting at them; ``model_kw`` overrides the
    configuration's model arguments."""
    from mem_tpu_torch.models.registry import create_model
    from mem_tpu_torch.train.mixup import make_mixup
    from mem_tpu_torch.train.optim import create_optimizer
    from mem_tpu_torch.train.steps import make_finetune_train_step

    name, kw = cfg["model"]
    model = create_model(name, **resolved({**kw, **(model_kw or {})}), device=device)
    model.init_weights(torch.Generator().manual_seed(0))
    o, s = cfg["optimizer"], cfg["step"]
    opt = create_optimizer(model, float(cfg["lr"][0]), o["weight_decay"],
                           layer_decay=o["layer_decay"], num_layers=o["num_layers"])
    mix = make_mixup(**cfg["mixup"])
    ema = [p.detach().clone() for p in model.parameters()]
    step = make_finetune_train_step(
        model, opt, cfg["preproc"], s["num_classes"], cfg["lr"],
        np.full(len(cfg["lr"]), o["weight_decay"]), mixup=mix, smoothing=s["smoothing"],
        update_freq=s["update_freq"], ema=ema, ema_decay=s["ema_decay"])
    return step, model, mix


def micro_batches(cfg, mix, device, n, first=1, seed=0):
    """``n`` steps' micro-batch lists: the host micro-batches with the
    augmentation and mixup draws of ``aug_seed + first + i`` (the CLI's
    ``_with_draws``), the events moved to the device once."""
    from mem_tpu_torch.data.device_pipeline import draw_train_aug
    from mem_tpu_torch.data.prefetch import to_device
    from mem_tpu_torch.train.mixup import draw_mixup

    pp = cfg["preproc"]
    out = []
    for m in range(cfg["step"]["update_freq"]):
        host = {k: v[m] for k, v in cfg["batch"].items()}
        base = to_device({k: v for k, v in host.items() if k != "aug_seed"}, device)
        steps = []
        for i in range(n):
            seeds = host["aug_seed"] + np.uint32(first + i)
            d = draw_train_aug(seeds, pp, pp.canvas_h, pp.canvas_w)
            if mix is not None:
                d.update(draw_mixup(mix, (seed, int(seeds[0])), len(seeds), pp.input_h,
                                    pp.input_w))
            steps.append({**base, **to_device(d, device)})
        out.append(steps)
    return [[mb[i] for mb in out] for i in range(n)]


def run(cfg, device, nsteps, tdir=None, model_kw=None, tool="trace_finetune"):
    step, _, mix = build(cfg, device, model_kw)
    B = cfg["batch"]["n_valid"].shape[1]
    t0 = time.perf_counter()
    batches = micro_batches(cfg, mix, device, nsteps + 1, first=0)
    print(f"host draws: {(time.perf_counter() - t0) * 1e3 / (nsteps + 1):.1f} ms a step "
          f"(made before the traced window)")
    return trace_train(step, batches, device, nsteps, tool, B, tdir=tdir)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    kv = parse_args(argv)
    bad = refuse("trace_finetune", kv)
    if bad:
        print(bad[1], file=sys.stderr)
        return bad[0]
    device = torch.device(kv.get("device", "cuda"))
    cfg = config(int(kv.get("B", 128)), mae=bool(int(kv.get("mae", 0))))
    print(gpu_name(device), flush=True)
    with toggles(kv):
        run(cfg, device, int(kv.get("steps", 3)), kv.get("dir"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
