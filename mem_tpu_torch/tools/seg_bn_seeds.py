#!/usr/bin/env python3
"""The segmentation train step's BatchNorm-buffer reading on several seeds,
with an f64 witness.

chip_smoke.py's check_seg_train_step holds the updated BatchNorm buffers of
one full-width train step (B=2, drop-path and dropout 0) on the card in f32
(TF32 off) against the same step on the CPU in f32, at SEG_STEP_BN_REL
relative L2. At B=2 the PSP module's pool-scale-1 branch normalises two
values a channel, and where they nearly agree (variance well below eps =
1e-5) the branch is a gain of up to rsqrt(eps) = 316 on the f32 rounding of
its input, which psp_bottleneck's batch mean then carries. This script reads
that gate on the synthetic train split drawn from each seed given
(chip_smoke.py's write_seg_pairs, first batch of 2), beside:

- each f32 step against the same step on the CPU in f64 (every BatchNorm,
  the PSP pooling and the heads' f32 casts in f64 too), so that the card's
  and the CPU's distances from the exact step can be compared;
- the step with the PSP BatchNorms' eps at SEG_DAMPED_EPS on both devices,
  which bounds that gain by 3.2 (the gradient gate's comparison);
- the pool-scale-1 BatchNorm's batch variances in the f64 step: how many
  channels lie below eps and below 10 eps, and the least.

Run on one card from the repository root:

    PYTHONPATH=. python3 mem_tpu_torch/tools/seg_bn_seeds.py 0 1 2 3

It prints one JSON line per seed and the card's name and power limit.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile

import numpy as np


@contextlib.contextmanager
def f64_heads(torch):
    """While open, ``Tensor.float()`` leaves f64 tensors as they are and the
    PSP pooling matrices are f64, so that a model cast to f64 runs its
    BatchNorms and heads in f64 rather than back in f32."""
    from mem_tpu_torch.models import segmentation as S

    to_f32, pool = torch.Tensor.float, S.adaptive_pool_matrix
    torch.Tensor.float = lambda t, *a, **k: t if t.dtype == torch.float64 else to_f32(t, *a, **k)
    S.adaptive_pool_matrix = lambda s, n: pool(s, n).astype(np.float64)
    try:
        yield
    finally:
        torch.Tensor.float, S.adaptive_pool_matrix = to_f32, pool


def run_step(torch, C, sd, host, device, dtype, eps=None):
    """The running buffers after one train step, and (f64 only) the batch
    variances of the pool-scale-1 BatchNorm's input."""
    from mem_tpu_torch.data.prefetch import to_device

    model, step = C.make_seg_step(torch, sd, device, dtype, lambda it: 5e-4, drop=0.0)
    if eps is not None:
        for si in range(len(model.decode_head.pool_scales)):
            getattr(model.decode_head, f"psp_{si}").bn.eps = eps
    seen = []
    model.decode_head.psp_0.bn.register_forward_pre_hook(
        lambda m, inp: seen.append(inp[0].detach().double().flatten(0, -2).var(0, False)))
    with f64_heads(torch) if dtype == torch.float64 else contextlib.nullcontext():
        if dtype == torch.float64:
            model.double()
        step(to_device(host, device), 0)
    bufs = {n: b.detach().double().cpu() for n, b in model.named_buffers() if "running_" in n}
    return bufs, seen[0].cpu()


def worst(torch, got, want):
    rel = {n: ((got[n] - want[n]).norm() / want[n].norm()).item() for n in want}
    name = max(rel, key=rel.get)
    return {"rel_l2_max": rel[name], "worst": name,
            "second": sorted(rel.values())[-2]}


def main(argv) -> int:
    import torch

    import chip_smoke as C
    from mem_tpu_torch.models.segmentation import build_segmentor
    from mem_tpu_torch.utils import env

    seeds = [int(s) for s in argv] or [0, 1, 2, 3]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(os.cpu_count() or 1)
    info = env.probe()
    print(info["nvidia_smi"] or f"{info['device_name']}, power limit not read", flush=True)
    cpu, dev = torch.device("cpu"), torch.device("cuda")
    seg = build_segmentor(11, 512, 768, 12, 12, torch.float32, cpu)
    seg.init_weights(torch.Generator().manual_seed(0))
    sd = seg.state_dict()
    del seg
    for seed in seeds:
        with tempfile.TemporaryDirectory() as tmp:
            root = os.path.join(tmp, "dsec")
            C.write_seg_pairs(root, "train", C.SEG_TRAIN_PAIRS, np.random.default_rng(seed))
            host = C.seg_host_batch(root, 2)
        exact, var = run_step(torch, C, sd, host, cpu, torch.float64)
        cpu32, _ = run_step(torch, C, sd, host, cpu, torch.float32)
        card32, _ = run_step(torch, C, sd, host, dev, torch.float32)
        cpu_d, _ = run_step(torch, C, sd, host, cpu, torch.float32, C.SEG_DAMPED_EPS)
        card_d, _ = run_step(torch, C, sd, host, dev, torch.float32, C.SEG_DAMPED_EPS)
        torch.cuda.empty_cache()
        print(json.dumps({
            "seed": seed, "gate": C.SEG_STEP_BN_REL,
            "card_vs_cpu_f32": worst(torch, card32, cpu32),
            "card_f32_vs_f64": worst(torch, card32, exact),
            "cpu_f32_vs_f64": worst(torch, cpu32, exact),
            "damped_card_vs_cpu_f32": worst(torch, card_d, cpu_d),
            "psp_pool1_var": {"channels": var.numel(),
                              "below_eps": int((var < 1e-5).sum()),
                              "below_10eps": int((var < 1e-4).sum()),
                              "min": var.min().item()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
