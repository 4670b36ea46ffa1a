#!/usr/bin/env python3
"""Times of the flat attention kernels K2f, K2b (short N) and K3f, K3b (long
N), and their ptxas lines, for the mem_tpu_torch tree in the current
directory: one leg of an A/B comparison of two trees on one card.

csrc/attention_fwd.cuh and attention_bwd.cuh are shared by the flat entry
points (K2f, K2b) and the head-major ones (K5a, K5c); attention_long_fwd.cuh
and attention_long_bwd.cuh by K3f, K3b and K5b, K5d, K5e. After a change to
them, check that the flat kernels did not move: unpack the parent's package
into a git-ignored directory and run both trees in turns inside one call on
the card, since two calls may land on two cards:

    git archive <parent> mem_tpu_torch | tar -x -C _chipcheck/parent
    for t in parent change change parent; do
      if [ $t = parent ]; then d=_chipcheck/parent; else d=.; fi
      (cd $d && PYTHONPATH=. python3 <repo>/mem_tpu_torch/tools/ab_flat_attention.py $t)
    done

Each leg builds the tree's kernels, prints the registers, shared memory and
spills ptxas reports for every flat kernel of both families (the short
family's tensor-core instantiations, every long kernel), then three medians
of 40 CUDA-event timings of K2f and K2b at (B, 197, 768) bf16 for B = 8 and
64, and of K3f and K3b at (8, 1025, 768) bf16. Two processes on the same
code differ by a few per cent: compare the ptxas lines first, and read a
time difference against the spread between the two legs of one tree.
"""
import re
import statistics
import sys

import torch

from mem_tpu_torch.kernels import build
from mem_tpu_torch.ops import attention as A


def time_ms(fn, runs=40, warmup=8):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def flat_kernel(name: str) -> bool:
    """A flat kernel of either family (the head-major translation units
    carry "bhnd" in their mangled names)."""
    return "bhnd" not in name and ("flat_mma" in name or "attention_long" in name)


def main(tag: str) -> None:
    build.library()
    kernel = spill = None
    for line in build.build_log().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = m.group(1)
        if "spill" in line:
            spill = line.strip()
        if "registers" in line and kernel and flat_kernel(kernel):
            print(tag, kernel[-64:], "|", line.strip().replace("ptxas info    : ", "")[:64],
                  "|", (spill or "")[-58:])
    for B in (8, 64):
        q, k, v, do = (torch.randn(B, 197, 768, device="cuda", dtype=torch.bfloat16)
                       for _ in range(4))
        bias = torch.randn(12, 197, 197, device="cuda")
        fwd = [time_ms(lambda: A._forward(q, k, v, bias, 0.125)) for _ in range(3)]
        bwd = [time_ms(lambda: A.fused_attention_flat_bwd(q, k, v, bias, do, 0.125))
               for _ in range(3)]
        print(tag, "B", B, "K2f ms", fwd, "K2b ms", bwd, flush=True)
    q, k, v, do = (torch.randn(8, 1025, 768, device="cuda", dtype=torch.bfloat16)
                   for _ in range(4))
    bias = torch.randn(12, 1025, 1025, device="cuda")
    fwd = [time_ms(lambda: A._forward_long(q, k, v, bias, 0.125)) for _ in range(3)]
    bwd = [time_ms(lambda: A.fused_attention_flat_long_bwd(q, k, v, bias, do, 0.125))
           for _ in range(3)]
    print(tag, "B", 8, "N", 1025, "K3f ms", fwd, "K3b ms", bwd, flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree")
