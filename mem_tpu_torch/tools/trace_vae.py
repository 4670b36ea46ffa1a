"""Trace the discrete-VAE train step (stage 1 of the pipeline) on the card
and print where its device time goes.

Port of scripts/trace_vae.py. On the card, from the repo root::

    python -m mem_tpu_torch.tools.trace_vae [B=128] [steps=3] [batch_ops=1]
        [dir=<trace dir>] [device=cuda|cpu]

The reference's step (the bf16 ``DiscreteVAE`` at its defaults: 224^2, 8192
tokens, codebook 32, 4 layers, 3 ResBlocks, hidden 384; B=128 samples of
30,000 events from ``np.random.default_rng(0)``; RandAugment with
``batch_ops``, ColorJitter 0.2; Adam (0.9, 0.999, eps 1e-8) at lr 1e-3,
temperature 0.9, clip 1e-2 as the reference's ``main`` passes them) through
``train.steps.make_vae_train_step``: two warm-up steps, then ``steps`` traced
steps with the draws of ``aug_seed`` + 1, + 2, ... made before the window.
``step_timers.analyze`` prints the breakdown (K1 once a step; the
convolutions are cuDNN's). Runs on the card unless ``device=cpu``; exits 2
without one.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from mem_tpu_torch.tools.step_timers import gpu_name, parse_args, refuse, resolved, trace_train
from mem_tpu_torch.tools.trace_pretrain import event_batch, step_batches


def config(B=128, N=30000, batch_ops=True) -> dict:
    """What :func:`build` builds and the step's arguments, as plain values
    (trace_vae.py:24-52, 60)."""
    from mem_tpu_torch.data.device_pipeline import PreprocConfig

    return dict(
        vae=dict(dtype="bfloat16"),
        batch=event_batch(np.random.default_rng(0), B, N, mask=False),
        preproc=PreprocConfig(canvas_h=256, canvas_w=256, rand_aug=True,
                              rand_aug_batch_ops=batch_ops, color_jitter=0.2),
        optimizer=dict(betas=(0.9, 0.999), eps=1e-8),
        step=dict(lr=1e-3, temp=0.9, clip=1e-2))


def build(cfg, device, vae_kw=None):
    """(step, vae) of ``cfg`` on ``device``, weights drawn from seed 0;
    ``vae_kw`` overrides the configuration's VAE arguments."""
    from mem_tpu_torch.models.discrete_vae import DiscreteVAE
    from mem_tpu_torch.train.steps import make_vae_train_step

    vae = DiscreteVAE(**resolved({**cfg["vae"], **(vae_kw or {})}), device=device)
    vae.init_weights(torch.Generator().manual_seed(0))
    s = cfg["step"]
    opt = torch.optim.Adam(vae.parameters(), lr=s["lr"], **cfg["optimizer"])
    return make_vae_train_step(vae, opt, cfg["preproc"], s["clip"]), vae


def run(cfg, device, nsteps, tdir=None, vae_kw=None, tool="trace_vae"):
    step, _ = build(cfg, device, vae_kw)
    s = cfg["step"]
    B = len(cfg["batch"]["n_valid"])
    batches, draw_ms = step_batches(cfg["batch"], cfg["preproc"], device, nsteps + 1, first=0)
    print(f"host draws: {draw_ms:.1f} ms a step (made before the traced window)")
    return trace_train(lambda b, it: step(b, it, s["lr"], s["temp"]), batches, device, nsteps,
                       tool, B, tdir=tdir)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    kv = parse_args(argv)
    bad = refuse("trace_vae", kv)
    if bad:
        print(bad[1], file=sys.stderr)
        return bad[0]
    device = torch.device(kv.get("device", "cuda"))
    print(gpu_name(device), flush=True)
    run(config(int(kv.get("B", 128)), batch_ops=bool(int(kv.get("batch_ops", 1)))), device,
        int(kv.get("steps", 3)), kv.get("dir"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
