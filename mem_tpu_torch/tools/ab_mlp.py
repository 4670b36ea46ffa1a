#!/usr/bin/env python3
"""Times of the fused MLP kernels K6f and K6b at the finetune shape, and
their ptxas lines, for the mem_tpu_torch tree in the current directory: one
leg of an A/B comparison of two trees on one card.

csrc/gemm_sm90.cuh holds K6's Hopper GEMM body, which csrc/mlp_fwd.cu and
mlp_bwd.cu launch for bf16 at the model's widths; mlp_rows.cuh and the
columns kernel of mlp_bwd.cu are the scalar kernels of every other case.
After a change to them, unpack the parent's package into a git-ignored
directory and run both trees in turns inside one call on the card, since
two calls may land on two cards:

    git archive <parent> mem_tpu_torch | tar -x -C _chipcheck/parent
    for t in parent change change parent; do
      if [ $t = parent ]; then d=_chipcheck/parent; else d=.; fi
      (cd $d && PYTHONPATH=. python3 <repo>/mem_tpu_torch/tools/ab_mlp.py $t)
    done

Each leg builds the tree's kernels, prints the registers and spills ptxas
reports for every kernel whose name holds "mlp_", then, at (25216, 768,
3072) bf16 (the finetune micro-batch of 128 samples of 197 tokens), three
medians of 20 CUDA-event timings of ``mlp_fwd_2d`` (K6f) and ``mlp_bwd_2d``
(K6b) and the device time of each of their kernels per launch
(torch.profiler), through entry points that every tree since the port's
fifth slice has. With a second argument, a list such as ``2,3,4,6`` (a tree
whose ``ops.mlp`` has ``WGRAD_MAX_CHUNKS``), it also times K6b's weight
gradients and sum pass at each number of row chunks, at 25216 and 12608
rows. The events time a whole call, the wrapper's host time included.
"""
import re
import sys

import torch

from mem_tpu_torch.kernels import build
from mem_tpu_torch.ops import mlp as M
from mem_tpu_torch.tools import time_ms

RUNS, WARMUP = 20, 5
ROWS, C, HIDDEN = 128 * 197, 768, 3072


def medians(fn):
    return [time_ms(fn, RUNS, WARMUP) for _ in range(3)]


def device_ms(fn, n=10):
    """{kernel: device ms per launch} of ``fn``'s kernels whose names hold
    "mlp_", from torch.profiler over ``n`` calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"mlp_\w+(<[^>]*>)?", e.key)
        if m and e.count:
            out[m.group(0)] = round(e.self_device_time_total / e.count / 1e3, 4)
    return out


def main(tag: str, chunks) -> None:
    build.library()
    kernel = spill = None
    for line in build.build_log().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = m.group(1)
        if "spill" in line:
            spill = line.strip()
        if "registers" in line and kernel and "mlp_" in kernel:
            print(tag, kernel[-60:], "|", line.strip().replace("ptxas info    : ", "")[:64],
                  "|", (spill or "")[-58:])
    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    x, do = (torch.randn(ROWS, C, generator=g).to(bf).cuda() for _ in range(2))
    w1 = (0.05 * torch.randn(C, HIDDEN, generator=g)).to(bf).cuda()
    w2 = (0.05 * torch.randn(HIDDEN, C, generator=g)).to(bf).cuda()
    b1, b2 = ((0.1 * torch.randn(n, generator=g)).to(bf).cuda() for n in (HIDDEN, C))
    _, h = M.mlp_fused_reference(x, w1, b1, w2, b2)
    legs = (("K6f", lambda: M.mlp_fwd_2d(x, w1, b1, w2, b2, True)),
            ("K6b", lambda: M.mlp_bwd_2d(do, h, x, w1, w2)))
    print(tag, "rows", ROWS, *(v for name, fn in legs for v in (name + " ms", medians(fn))),
          flush=True)
    for name, fn in legs:
        parts = device_ms(fn)
        print(tag, "rows", ROWS, name, "device ms", round(sum(parts.values()), 4), parts,
              flush=True)
    for n in chunks:
        M.WGRAD_MAX_CHUNKS = n
        for rows in (ROWS, ROWS // 2):
            parts = device_ms(lambda: M.mlp_bwd_2d(do[:rows], h[:rows], x[:rows], w1, w2))
            print(tag, "rows", rows, "chunks", M.wgrad_chunk_plan(rows), "device ms",
                  {k: v for k, v in parts.items() if "wgrad" in k}, flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree",
         [int(n) for n in sys.argv[2].split(",")] if len(sys.argv) > 2 else [])
