"""Trace the ViT-B MEM pretraining step on the card and print where its
device time goes.

Port of scripts/trace_pretrain.py. On the card, from the repo root::

    python -m mem_tpu_torch.tools.trace_pretrain [B=128] [steps=3] [batch_ops=1]
        [gathered=1] [bf16_moments=0] [mode=phases] [fa=0|1] [flat=0|1]
        [fused_mlp=0|1] [dir=<trace dir>] [device=cuda|cpu]

It builds the reference's step at full width (``pt_vit`` bf16 with
init_values 0.1, the shared rel-pos bias, drop-path 0.1 and, with
``gathered``, 98 masked tokens gathered; the bf16 ``DiscreteVAE``; B=128
samples of 30,000 events from ``np.random.default_rng(0)``; RandAugment with
``batch_ops``, ColorJitter 0.2; the cosine schedule 5e-4 -> 1e-5 over 10 x
100 steps after 10 of warm-up; weight decay 0.05, clip 30; ``bf16_moments``
stores AdamW's moments in bf16) through ``train.steps.make_pretrain_train_step``,
takes two warm-up steps, then ``steps`` traced steps, each with its own
augmentation draws (``aug_seed`` + 1, + 2, ...: the RandAugment op pair is
sampled, not frozen). The draws are made on the host before the traced
window; their time is printed on a line of its own.

The traced steps run twice (``step_timers.trace_steps``): timed by CUDA
events, then under torch.profiler with the launch counters set to 0.
:func:`analyze` (``step_timers.analyze``, the tools' shared breakdown)
prints the reference's device time per step and top 25 ops,
and beside them the wall ms per step and the busy share, the device ms by
family (each hand-written kernel by its launch counter), each hand-written
kernel's launches recorded by the profiler beside those counted (a trace can
lose records: its device ms per step is extrapolated from the recorded mean
times the counted launches), the peak memory and the card's name and power
limit, and ends with one JSON line of those fields. With ``dir`` the trace
is also written there as a Chrome trace.

``mode=phases`` traces the preprocessing, the tokenizer's labels and the
gradient step + update apart, three calls each on inputs of their own.

``fa``, ``flat`` and ``fused_mlp`` set ``ops.attention.ENABLED``,
``models.vit.FLAT_ATTN`` and ``FUSED_MLP`` for the run. ``remat`` and
``pad_attn`` name XLA toggles the port leaves out (ROADMAP, "Not ported"):
they exit 2. Runs on the card unless ``device=cpu``; exits 2 without one.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from mem_tpu_torch.tools.step_timers import (  # noqa: F401  (analyze: the reference's name)
    analyze, dtype_of, gpu_name, parse_args, refuse, resolved, toggles, trace_and_analyze,
    trace_train)
from mem_tpu_torch.train.optim import state_bytes

def event_batch(rng, B, N, mask=True):
    """The reference's synthetic pretraining batch (trace_pretrain.py:38-52),
    drawn in its order from ``rng``."""
    batch = {
        "events": rng.random((B, N, 4)).astype(np.float32) * [240, 180, 1e6, 1],
        "n_valid": np.full((B,), N, np.int32),
        "label": np.zeros((B,), np.int64),
        "sample_h": np.full((B,), 180, np.int32),
        "sample_w": np.full((B,), 240, np.int32),
        "time_flip": rng.random(B) < 0.5,
        "x_flip": rng.random(B) < 0.5,
        "shift_xy": rng.integers(-8, 9, (B, 2)).astype(np.int32),
        "aug_seed": np.arange(B, dtype=np.uint32),
    }
    if mask:
        batch["mask"] = np.tile(np.arange(196) < 98, (B, 1))
    batch["events"][..., 3] = rng.choice([-1.0, 1.0], (B, N))
    return batch


def config(batch_ops=True, gathered=True, B=128, N=30000, bf16_moments=False) -> dict:
    """What :func:`build` builds, as plain values: the model's registry name
    and keyword arguments, the tokenizer's, the host batch, the
    preprocessing, the lr schedule and the optimizer's settings (dtypes by
    name)."""
    from mem_tpu_torch.data.device_pipeline import PreprocConfig
    from mem_tpu_torch.train.schedules import cosine_scheduler

    kw = dict(dtype="bfloat16", init_values=0.1, use_shared_rel_pos_bias=True,
              drop_path_rate=0.1)
    if gathered:
        kw["num_masked_tokens"] = 98
    return dict(
        model=("pt_vit", kw), vae=dict(dtype="bfloat16"),
        batch=event_batch(np.random.default_rng(0), B, N),
        preproc=PreprocConfig(canvas_h=256, canvas_w=256, rand_aug=True,
                              rand_aug_batch_ops=batch_ops, color_jitter=0.2),
        lr=cosine_scheduler(5e-4, 1e-5, 10, 100, warmup_steps=10),
        optimizer=dict(weight_decay=0.05, clip_grad=30.0,
                       moment_dtype="bfloat16" if bf16_moments else None))


def build_vae(cfg, device, vae_kw=None):
    """The frozen tokenizer of ``cfg``, weights drawn from seed 1."""
    from mem_tpu_torch.models.discrete_vae import DiscreteVAE

    vae = DiscreteVAE(**resolved({**cfg["vae"], **(vae_kw or {})}), device=device)
    vae.init_weights(torch.Generator().manual_seed(1))
    return vae.eval().requires_grad_(False)


def build(cfg, device, model_kw=None, vae_kw=None):
    """(step, model, optimizer, vae) of ``cfg`` on ``device``, weights drawn
    from seed 0; ``model_kw`` / ``vae_kw`` override the configuration's
    (the tests' small sizes)."""
    from mem_tpu_torch.models.registry import create_model
    from mem_tpu_torch.train.optim import create_optimizer
    from mem_tpu_torch.train.steps import make_pretrain_train_step

    name, kw = cfg["model"]
    model = create_model(name, **resolved({**kw, **(model_kw or {})}), device=device)
    model.init_weights(torch.Generator().manual_seed(0))
    vae = build_vae(cfg, device, vae_kw)
    o = cfg["optimizer"]
    opt = create_optimizer(model, float(cfg["lr"][0]), o["weight_decay"],
                           moment_dtype=dtype_of(o["moment_dtype"]))
    step = make_pretrain_train_step(model, vae, opt, cfg["preproc"], cfg["lr"],
                                    np.full(len(cfg["lr"]), o["weight_decay"]), o["clip_grad"])
    return step, model, opt, vae


def step_batches(batch, pp, device, n, first=1):
    """``n`` device batches of one host batch, batch i with the training
    draws of ``aug_seed + first + i`` (the reference's device-side bump
    before each traced step), and the host ms per batch the draws took. The
    events go to the device once and are shared."""
    from mem_tpu_torch.data.device_pipeline import draw_train_aug
    from mem_tpu_torch.data.prefetch import to_device

    base = to_device({k: v for k, v in batch.items() if k != "aug_seed"}, device)
    t0 = time.perf_counter()
    draws = [draw_train_aug(batch["aug_seed"] + np.uint32(first + i), pp, pp.canvas_h,
                            pp.canvas_w) for i in range(n)]
    draw_ms = (time.perf_counter() - t0) * 1e3 / max(n, 1)
    return [{**base, **to_device(d, device)} for d in draws], draw_ms


def phases(cfg, device, n=3, model_kw=None, vae_kw=None):
    """The preprocessing, the tokenizer's labels and the gradient step +
    update traced apart, ``n`` calls each on inputs of their own (aug_seed
    bumped; the labels of each call's images)."""
    from mem_tpu_torch.data.device_pipeline import preprocess_batch
    from mem_tpu_torch.models.pretrain import (masked_cross_entropy,
                                               masked_cross_entropy_gathered)
    from mem_tpu_torch.train.optim import clip_grad_global_norm, set_schedule
    from mem_tpu_torch.train.schedules import at
    from mem_tpu_torch.train.steps import step_generator

    _, model, opt, vae = build(cfg, device, model_kw, vae_kw)
    pp, B = cfg["preproc"], len(cfg["batch"]["n_valid"])
    batches, draw_ms = step_batches(cfg["batch"], pp, device, n + 1, first=0)
    print(f"host draws: {draw_ms:.1f} ms a batch (before the traced windows)")
    with torch.no_grad():
        imgs = [preprocess_batch(b, pp, True) for b in batches]
        labs = [vae.get_codebook_indices(im) for im in imgs]
    mask = batches[0]["mask"]
    params = [p for p in model.parameters() if p.requires_grad]
    wd = cfg["optimizer"]["weight_decay"]

    def grad(i):
        model.train()
        out = model(imgs[i], mask, generator=step_generator(0, 100 + i, imgs[i].device))
        if isinstance(out, tuple):
            loss, _ = masked_cross_entropy_gathered(out[0], out[1], labs[i], mask)
        else:
            loss, _ = masked_cross_entropy(out, labs[i], mask)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        clip_grad_global_norm(params, cfg["optimizer"]["clip_grad"])
        set_schedule(opt, at(cfg["lr"], 100 + i), wd)
        opt.step()
        return loss.detach()

    grad(n)                                   # warm-up on the spare inputs
    with torch.no_grad():
        pre = [lambda b=b: preprocess_batch(b, pp, True) for b in batches[:n]]
        vae_calls = [lambda im=im: vae.get_codebook_indices(im) for im in imgs[:n]]
        out = {}
        for tag, calls in (("pre", pre), ("vae", vae_calls)):
            out[tag] = trace_and_analyze(calls, device, n, f"trace_pretrain phase {tag}", B,
                                         label=f"--- phase {tag} ---")
    out["grad"] = trace_and_analyze([lambda i=i: grad(i) for i in range(n)], device, n,
                                    "trace_pretrain phase grad", B, label="--- phase grad ---")
    return out


def run(cfg, device, nsteps, tdir=None, model_kw=None, vae_kw=None, tool="trace_pretrain"):
    """Two warm-up steps, then ``nsteps`` traced steps with their own draws;
    returns analyze's dict with the traced steps' losses."""
    step, _, opt, _ = build(cfg, device, model_kw, vae_kw)
    batches, draw_ms = step_batches(cfg["batch"], cfg["preproc"], device, nsteps + 1, first=0)
    print(f"host draws: {draw_ms:.1f} ms a step (made before the traced window)")
    return trace_train(step, batches, device, nsteps, tool, len(cfg["batch"]["n_valid"]),
                       tdir=tdir, extra=lambda: {"optimizer_state_bytes": state_bytes(opt)})


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    kv = parse_args(argv)
    bad = refuse("trace_pretrain", kv)
    if bad:
        print(bad[1], file=sys.stderr)
        return bad[0]
    device = torch.device(kv.get("device", "cuda"))
    batch_ops = bool(int(kv.get("batch_ops", 1)))
    gathered = bool(int(kv.get("gathered", 1)))
    B, nsteps = int(kv.get("B", 128)), int(kv.get("steps", 3))
    cfg = config(batch_ops, gathered, B, bf16_moments=bool(int(kv.get("bf16_moments", 0))))
    print(gpu_name(device), flush=True)
    with toggles(kv):
        if kv.get("mode") == "phases":
            phases(cfg, device)
            return 0
        run(cfg, device, nsteps, kv.get("dir"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
