#!/usr/bin/env python3
"""Times of the flat attention kernels K2f, K2b (short N) and K3f, K3b (long
N), of the head-major K5a, K5c (K2's bodies) and K5e, K5d (K3b's body), and
their ptxas lines, for the mem_tpu_torch tree in the current directory: one
leg of an A/B comparison of two trees on one card.

csrc/attention_long_fwd.cuh and attention_long_bwd.cuh hold K3's Hopper
bodies, which K3f, K3b and K5b, K5d, K5e take, and K2f, K2b and K5a, K5c
for bf16 at head dim 64 and N <= 256 too (so on such a tree the "K2f" and
"K3f-body" legs below launch the same kernels); attention_fwd.cuh and
attention_bwd.cuh hold K2's scalar kernels (and K2b's `mma.sync`
tensor-core kernel, X3's yardstick). After a
change to them, check that the other kernels did not move: unpack the
parent's package into a git-ignored directory and run both trees in turns
inside one call on the card, since two calls may land on two cards:

    git archive <parent> mem_tpu_torch | tar -x -C _chipcheck/parent
    for t in parent change change parent; do
      if [ $t = parent ]; then d=_chipcheck/parent; else d=.; fi
      (cd $d && PYTHONPATH=. python3 <repo>/mem_tpu_torch/tools/ab_flat_attention.py $t)
    done

Each leg builds the tree's kernels, prints the registers, shared memory and
spills ptxas reports for K2's flat tensor-core kernels (K2b's `mma.sync`
kernel) and for every long kernel, flat and head-major, then three medians of 40 CUDA-event
timings each of:
- K2f and K2b at (B, 197, 768) bf16 for B = 8 and 64, and at the same
  shapes K3f's and K3b's bodies through their flat entry points
  (``_forward_long``, ``fused_attention_flat_long_bwd``) and one
  ``scaled_dot_product_attention`` call (the bias as its mask) and its
  backward;
- K5a and K5c at (128, 12, 197, 64), K3f's and K3b's bodies through the
  head-major entry points (``mem_attention_long_fwd_bhnd``,
  ``mem_attention_bwd_whole_bhnd``) at that shape, and the SDPA call;
- K3f and K3b at (B, 1025, 768) bf16 for B = 8 and 16, K5e at (16, 12,
  1025, 64) and K5d at (32, 12, 401, 64);
all through entry points of ``ops.attention`` that the parent tree has too.
The events time a whole call, so the wrapper's host time before the launch
counts too; at N = 197 each leg also prints the device time per call of the
attention kernels (torch.profiler: for each kernel its mean per launch,
summed over the call's kernels), which compares the bodies alone. Two
processes on the same code differ by a few per cent: compare the ptxas
lines first, and read a time difference against the spread between the two
legs of one tree. The timer comes from the tree under test
(``mem_tpu_torch.tools.time_ms``), so both trees must have it.
"""
import re
import sys

import torch
import torch.nn.functional as F

from mem_tpu_torch.kernels import build
from mem_tpu_torch.ops import attention as A
from mem_tpu_torch.tools import time_ms

RUNS, WARMUP = 40, 8


def shown(name: str) -> bool:
    """A flat tensor-core kernel of K2's bodies or any long kernel (the
    head-major translation units carry "bhnd" in their mangled names)."""
    return ("bhnd" not in name and "flat_mma" in name) or "attention_long" in name


def medians(fn):
    return [time_ms(fn, RUNS, WARMUP) for _ in range(3)]


def device_ms(fn, n=20):
    """Device time per call of ``fn``'s attention kernels: for each kernel
    whose name holds "attention", the profiler's mean per launch, summed."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total / e.count for e in prof.key_averages()
               if "attention" in e.key and e.count) / 1e3


def sdpa(q, k, v, bias):
    """(forward, backward) callables of one scaled_dot_product_attention call
    on (B, H, N, D) views of the operands with the bias as its mask."""
    mask = bias.to(q.dtype)[None].contiguous().requires_grad_()
    qh, kh, vh = (t.detach().clone().requires_grad_() for t in (q, k, v))
    fwd = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,  # noqa: E731
                                                 scale=0.125)
    out = fwd()
    do = torch.randn_like(out)
    bwd = lambda: torch.autograd.grad(out, (qh, kh, vh, mask), do,  # noqa: E731
                                      retain_graph=True)
    return fwd, bwd


def main(tag: str) -> None:
    build.library()
    kernel = spill = None
    for line in build.build_log().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = m.group(1)
        if "spill" in line:
            spill = line.strip()
        if "registers" in line and kernel and shown(kernel):
            print(tag, "bhnd" if "bhnd" in kernel else "flat", kernel[-60:], "|",
                  line.strip().replace("ptxas info    : ", "")[:64], "|", (spill or "")[-58:])
    bf = torch.bfloat16
    for B in (8, 64):
        q, k, v, do = (torch.randn(B, 197, 768, device="cuda", dtype=bf) for _ in range(4))
        bias = torch.randn(12, 197, 197, device="cuda")
        heads = lambda t: t.view(B, 197, 12, 64).transpose(1, 2)  # noqa: E731
        s_fwd, s_bwd = sdpa(heads(q), heads(k), heads(v), bias)
        legs = (("K2f", lambda: A._forward(q, k, v, bias, 0.125)),
                ("K2b", lambda: A.fused_attention_flat_bwd(q, k, v, bias, do, 0.125)),
                ("K3f-body", lambda: A._forward_long(q, k, v, bias, 0.125)),
                ("K3b-body", lambda: A.fused_attention_flat_long_bwd(q, k, v, bias, do, 0.125)))
        print(tag, "B", B, "N", 197, *(x for name, fn in legs for x in (name + " ms",
                                                                         medians(fn))),
              "SDPA ms", medians(s_fwd), "SDPA-bwd ms", medians(s_bwd), flush=True)
        print(tag, "B", B, "N", 197, "device ms",
              {name: round(device_ms(fn), 4) for name, fn in legs}, flush=True)
        del q, k, v, do, bias, s_fwd, s_bwd
    B, H, N, D = 128, 12, 197, 64
    q, k, v, do = (torch.randn(B, H, N, D, device="cuda", dtype=bf) for _ in range(4))
    bias = torch.randn(H, N, N, device="cuda")
    s_fwd, s_bwd = sdpa(q, k, v, bias)
    long_fwd = lambda: A._long_fwd("fused_attention_long", "mem_attention_long_fwd_bhnd",  # noqa: E731
                                   q, k, v, bias, 0.125, B, N, H, D)
    long_bwd = lambda: A._long_bwd("fused_attention_bwd_whole",  # noqa: E731
                                   "mem_attention_bwd_whole_bhnd", q, k, v, bias, do, 0.125,
                                   B, N, H, D)
    legs = (("K5a", lambda: A.fused_attention(q, k, v, bias, 0.125)),
            ("K5c", lambda: A.fused_attention_bwd(q, k, v, bias, do, 0.125)),
            ("K3f-body-bhnd", long_fwd), ("K3b-body-bhnd", long_bwd))
    print(tag, "B", B, "H", H, "N", N, *(x for name, fn in legs for x in (name + " ms",
                                                                          medians(fn))),
          "SDPA ms", medians(s_fwd), "SDPA-bwd ms", medians(s_bwd), flush=True)
    print(tag, "B", B, "H", H, "N", N, "device ms",
          {name: round(device_ms(fn), 4) for name, fn in legs}, flush=True)
    del q, k, v, do, bias, s_fwd, s_bwd
    for B in (8, 16):
        q, k, v, do = (torch.randn(B, 1025, 768, device="cuda", dtype=bf) for _ in range(4))
        bias = torch.randn(12, 1025, 1025, device="cuda")
        print(tag, "B", B, "N", 1025,
              "K3f ms", medians(lambda: A._forward_long(q, k, v, bias, 0.125)),
              "K3b ms", medians(
                  lambda: A.fused_attention_flat_long_bwd(q, k, v, bias, do, 0.125)),
              flush=True)
        del q, k, v, do, bias
    for name, B, N in (("K5e", 16, 1025), ("K5d", 32, 401)):
        q, k, v, do = (torch.randn(B, 12, N, 64, device="cuda", dtype=bf) for _ in range(4))
        bias = torch.randn(12, N, N, device="cuda")
        print(tag, "B", B, "H", 12, "N", N, name, "ms",
              medians(lambda: A.fused_attention_bwd(q, k, v, bias, do, 0.125)), flush=True)
        del q, k, v, do, bias


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree")
