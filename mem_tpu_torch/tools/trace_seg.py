"""Trace the DSEC segmentation train step (EvBEiT-512 + UPerNet, B=8) on the
card and print where its device time goes.

Port of scripts/trace_seg.py. On the card, from the repo root::

    python -m mem_tpu_torch.tools.trace_seg [B=8] [steps=3] [batch_ops=1]
        [flat_long=0|1] [dir=<trace dir>] [device=cuda|cpu]

The reference's step (``EncoderDecoder``: 11 classes, EvBEiT at 512^2, 768
wide, 12 blocks of 12 heads, drop-path 0.1, bf16; B=8 windows of 180,000
events from ``np.random.default_rng(0)``, presorted by y as the production
loader ships them, labels and flips from the same generator; RandAugment
with ``batch_ops``; AdamW (0.9, 0.999, eps 1e-8) with the poly schedule from
5e-4 over 160,000 iterations, weight decay 0.05, layer decay 0.65 over 12
blocks) through ``train.steps.make_seg_steps`` with ``y_sorted``: two
warm-up steps, then ``steps`` traced steps on the same batch and draws, as
the reference's. ``step_timers.analyze`` prints the breakdown (K4
once, K3f and K3b 12 times a step). ``flat_long=0`` sends the 1025 tokens to
K5b / K5e. Runs on the card unless ``device=cpu``; exits 2 without one.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from mem_tpu_torch.tools.step_timers import (gpu_name, parse_args, refuse, resolved, toggles,
                                             trace_train)


def seg_batch(rng, B, N):
    """The reference's synthetic DSEC batch (trace_seg.py:34-45): events in
    the 640 x 440 frame with p = +-1, labels, flips, presorted by y."""
    from mem_tpu_torch.data.seg_pipeline import SEG_H, SEG_W

    batch = {
        "events": rng.random((B, N, 4)).astype(np.float32) * [SEG_W, SEG_H, 1, 1],
        "n_valid": np.full((B,), N, np.int32),
        "label": rng.integers(0, 11, (B, SEG_H, SEG_W)).astype(np.int32),
        "flip": rng.random(B) < 0.5,
        "aug_seed": np.arange(B, dtype=np.uint32),
    }
    batch["events"][..., 3] = rng.choice([-1.0, 1.0], (B, N))
    order = np.argsort(batch["events"][..., 1], axis=1)
    batch["events"] = np.take_along_axis(batch["events"], order[..., None], axis=1)
    return batch


def config(B=8, N=180000, batch_ops=True) -> dict:
    """What :func:`build` builds, as plain values (trace_seg.py:25-71)."""
    return dict(
        model=dict(num_classes=11, backbone_cfg=dict(img_size=512, embed_dim=768, depth=12,
                                                     num_heads=12, drop_path_rate=0.1),
                   dtype="bfloat16"),
        batch=seg_batch(np.random.default_rng(0), B, N),
        lr=dict(base_lr=5e-4, max_iters=160000),
        optimizer=dict(weight_decay=0.05, layer_decay=0.65, num_layers=12, betas=(0.9, 0.999),
                       eps=1e-8),
        step=dict(num_classes=11, rand_aug=True, rand_aug_batch_ops=batch_ops, y_sorted=True))


def build(cfg, device, backbone_kw=None):
    """(train step, model) of ``cfg`` on ``device``, weights drawn from seed
    0; ``backbone_kw`` overrides the backbone's arguments."""
    from mem_tpu_torch.models.segmentation import EncoderDecoder
    from mem_tpu_torch.train.optim import create_optimizer
    from mem_tpu_torch.train.schedules import poly_lr_schedule
    from mem_tpu_torch.train.steps import make_seg_steps

    m = dict(cfg["model"])
    m["backbone_cfg"] = {**m["backbone_cfg"], **(backbone_kw or {})}
    model = EncoderDecoder(**resolved(m), device=device)
    model.init_weights(torch.Generator().manual_seed(0))
    o, s = cfg["optimizer"], cfg["step"]
    opt = create_optimizer(model, cfg["lr"]["base_lr"], o["weight_decay"],
                           layer_decay=o["layer_decay"], num_layers=o["num_layers"],
                           betas=o["betas"], opt_eps=o["eps"])
    step, _ = make_seg_steps(model, opt, poly_lr_schedule(**cfg["lr"]), o["weight_decay"],
                             **s)
    return step, model


def device_batch(cfg, device):
    """The host batch with its RandAugment draws, on ``device``."""
    from mem_tpu_torch.data.prefetch import to_device
    from mem_tpu_torch.data.seg_pipeline import draw_seg_train_aug

    batch = dict(cfg["batch"])
    batch.update(draw_seg_train_aug(batch["aug_seed"], cfg["step"]["rand_aug_batch_ops"]))
    return to_device({k: v for k, v in batch.items() if k != "aug_seed"}, device)


def run(cfg, device, nsteps, tdir=None, backbone_kw=None, tool="trace_seg"):
    step, _ = build(cfg, device, backbone_kw)
    return trace_train(step, [device_batch(cfg, device)] * (nsteps + 1), device, nsteps, tool,
                       len(cfg["batch"]["n_valid"]), unit="img", tdir=tdir)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    kv = parse_args(argv)
    bad = refuse("trace_seg", kv)
    if bad:
        print(bad[1], file=sys.stderr)
        return bad[0]
    device = torch.device(kv.get("device", "cuda"))
    print(gpu_name(device), flush=True)
    with toggles(kv):
        run(config(int(kv.get("B", 8)), batch_ops=bool(int(kv.get("batch_ops", 1)))), device,
            int(kv.get("steps", 3)), kv.get("dir"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
