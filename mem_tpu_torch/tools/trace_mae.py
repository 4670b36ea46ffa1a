"""Trace the MAE pretraining step (``--MAE 1``: pixel regression, no
tokenizer) on the card and print where its device time goes.

Port of scripts/trace_mae.py. On the card, from the repo root::

    python -m mem_tpu_torch.tools.trace_mae [B=128] [steps=3] [dir=<trace dir>]
        [device=cuda|cpu]

The reference's step (``mae_vit_base_patch16_dec512d8b`` at 224^2, bf16; B=128
samples of 30,000 events from ``np.random.default_rng(0)``; RandAugment with
batch ops, no ColorJitter; the cosine schedule 1.5e-4 -> 1e-6 over 10 x 100
steps after 10 of warm-up; weight decay 0.05) through
``train.steps.make_mae_train_step``, the shuffle noise drawn from each step's
generator as in the CLI: two warm-up steps, then ``steps`` traced steps with
the draws of ``aug_seed`` + 1, + 2, ... made before the window.
``step_timers.analyze`` prints the breakdown (K1 once, K2f and K2b
20 times a step: 12 encoder and 8 decoder blocks). Runs on the card unless
``device=cpu``; exits 2 without one.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from mem_tpu_torch.tools.step_timers import (gpu_name, parse_args, refuse, resolved, toggles,
                                             trace_train)
from mem_tpu_torch.tools.trace_pretrain import event_batch, step_batches


def config(B=128, N=30000) -> dict:
    """What :func:`build` builds, as plain values (trace_mae.py:25-54)."""
    from mem_tpu_torch.data.device_pipeline import PreprocConfig
    from mem_tpu_torch.train.schedules import cosine_scheduler

    return dict(
        model=("mae_vit_base_patch16_dec512d8b", dict(img_size=224, dtype="bfloat16")),
        batch=event_batch(np.random.default_rng(0), B, N, mask=False),
        preproc=PreprocConfig(canvas_h=256, canvas_w=256, rand_aug=True,
                              rand_aug_batch_ops=True, color_jitter=0.0),
        lr=cosine_scheduler(1.5e-4, 1e-6, 10, 100, warmup_steps=10),
        optimizer=dict(weight_decay=0.05))


def build(cfg, device, model_kw=None):
    """(step, model) of ``cfg`` on ``device``, weights drawn from seed 0;
    ``model_kw`` overrides the configuration's model arguments."""
    from mem_tpu_torch.models.mae import MaskedAutoencoderViT
    from mem_tpu_torch.models.registry import create_model
    from mem_tpu_torch.train.optim import create_optimizer
    from mem_tpu_torch.train.steps import make_mae_train_step

    name, kw = cfg["model"]
    kw = resolved({**kw, **(model_kw or {})})
    # the registry fixes ViT-B/16's geometry; the tests' small sizes go to the class
    model = (MaskedAutoencoderViT(**kw, device=device) if model_kw
             else create_model(name, **kw, device=device))
    model.init_weights(torch.Generator().manual_seed(0))
    wd = cfg["optimizer"]["weight_decay"]
    opt = create_optimizer(model, float(cfg["lr"][0]), wd)
    step = make_mae_train_step(model, opt, cfg["preproc"], cfg["lr"],
                               np.full(len(cfg["lr"]), wd))
    return step, model


def run(cfg, device, nsteps, tdir=None, model_kw=None, tool="trace_mae"):
    step, _ = build(cfg, device, model_kw)
    B = len(cfg["batch"]["n_valid"])
    batches, draw_ms = step_batches(cfg["batch"], cfg["preproc"], device, nsteps + 1, first=0)
    print(f"host draws: {draw_ms:.1f} ms a step (made before the traced window)")
    return trace_train(step, batches, device, nsteps, tool, B, tdir=tdir)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    kv = parse_args(argv)
    bad = refuse("trace_mae", kv)
    if bad:
        print(bad[1], file=sys.stderr)
        return bad[0]
    device = torch.device(kv.get("device", "cuda"))
    print(gpu_name(device), flush=True)
    with toggles(kv):
        run(config(int(kv.get("B", 128))), device, int(kv.get("steps", 3)), kv.get("dir"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
