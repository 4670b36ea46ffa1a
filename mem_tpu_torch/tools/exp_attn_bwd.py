"""The paired attention backward (X3) beside K2b's mma.sync kernel, on the H100.

Port of scripts/exp_attn_bwd.py. The reference asked whether K2b's two
depth-64 products per head (s = q k^T, dp = do v^T) run faster on the TPU's
128-deep matrix unit as ONE depth-128 product against the block-diagonal
[[k^T, 0], [0, v^T]]: twice the multiply-adds at twice the depth.
csrc/attention_bwd_pair.cu keeps that product, zero blocks included, on
Hopper's bf16 mma.sync (``fused_attention_flat_bwd_pair``); a k16 step costs
the same whatever the product's depth here, so the pair executes 7 N^2 D
multiply-adds per (b, h) where the algorithm needs 5. Its base is the body
it varies, K2b's mma.sync kernel (``fused_attention_flat_bwd_mma``);
K2b itself runs K3b's Hopper body on wgmma now.

On the card, from the repo root::

    python -m mem_tpu_torch.tools.exp_attn_bwd [B=128] [N=197] [H=12] [D=64] [steps=8]

It makes the reference's seeded operands (bf16 q, k, v, do of (B, N, H*D)
and an f32 (H, N, N) bias at 0.1 scale), checks the pair against the base (the
reference's 3e-2 tolerance, and whether they are equal bit for bit), times
both in one call in turns (base, pair, pair, base: the median of ``steps``
CUDA-event timings each after one warm-up call; the reference's nudge of q
between steps only defeated XLA's deduplication and is not needed here),
and prints the reference's lines with the TPU's matrix-unit floor replaced by
the H100's bound: the bytes moved over 3.35 TB/s and the five products over
989 TFLOP/s bf16, with the pair's executed operations beside it. Exits 1 if
the pair disagrees with the base, 2 without a card.
"""
from __future__ import annotations

import statistics
import sys

import numpy as np
import torch

from mem_tpu_torch.ops.attention import (fused_attention_flat_bwd_mma,
                                         fused_attention_flat_bwd_pair)
from mem_tpu_torch.tools import (PEAK_BF16_FLOPS, PEAK_BYTES_S, attention_bwd_bound,
                                 attention_bwd_work, time_ms)

TOL = 3e-2                 # the reference's tolerance, pair against base (exp_attn_bwd.py:158)


def make_operands(B: int, N: int, H: int, D: int, device):
    """The reference's seeded operands (exp_attn_bwd.py:142-147)."""
    rng = np.random.default_rng(0)
    C = H * D
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, N, C))).to(device, torch.bfloat16)
                   for _ in range(4))
    bias = torch.from_numpy(rng.standard_normal((H, N, N))).to(device, torch.float32) * 0.1
    return q, k, v, bias, do


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    kv = dict(a.split("=", 1) for a in argv)
    B, N, H, D = (int(kv.get(n, d)) for n, d in (("B", 128), ("N", 197), ("H", 12), ("D", 64)))
    steps = int(kv.get("steps", 8))
    if not torch.cuda.is_available():
        print("exp_attn_bwd: no CUDA device is available; the experiment runs on the card only",
              file=sys.stderr)
        return 2
    from mem_tpu_torch.utils.env import nvidia_smi

    print(nvidia_smi() or torch.cuda.get_device_name(0), flush=True)
    q, k, v, bias, do = make_operands(B, N, H, D, "cuda")
    scale = D ** -0.5
    base = lambda: fused_attention_flat_bwd_mma(q, k, v, bias, do, scale)  # noqa: E731
    pair = lambda: fused_attention_flat_bwd_pair(q, k, v, bias, do, scale)  # noqa: E731

    out_base, out_pair = base(), pair()
    torch.cuda.synchronize()
    ok = True
    for a, b, name in zip(out_base, out_pair, ("dq", "dk", "dv", "db")):
        a, b = a.float(), b.float()
        err = (a - b).abs().max().item()
        equal = torch.equal(a, b)
        within = bool(((a - b).abs() <= TOL + TOL * b.abs()).all())
        print(f"pair vs base {name}: bit-equal {equal}, max abs diff {err:.3e}", flush=True)
        ok &= within
    del out_base, out_pair

    t_base = [time_ms(base, steps, 1)]
    t_pair = [time_ms(pair, steps, 1), time_ms(pair, steps, 1)]
    t_base.append(time_ms(base, steps, 1))
    ms_base, ms_pair = statistics.mean(t_base), statistics.mean(t_pair)

    n_matmul = B * H * 5
    floor = attention_bwd_bound(B, N, H, D)[0]
    nbytes, flop = attention_bwd_work(B, N, H, D)
    pair_flop = 14 * B * H * N * N * D   # 7 N^2 D multiply-adds per (b, h)
    print(f"shapes B={B} N={N} H={H} D={D}: {n_matmul} matmuls/call")
    print(f"base bwd: {ms_base:.3f} ms/call ({ms_base * 1e6 / n_matmul:.0f} ns/matmul) "
          f"runs {t_base}")
    print(f"pair bwd: {ms_pair:.3f} ms/call ({ms_pair * 1e6 / n_matmul:.0f} ns/matmul) "
          f"runs {t_pair}")
    print(f"H100 bound: {floor:.3f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s -> "
          f"{nbytes / PEAK_BYTES_S * 1e3:.3f} ms; 5 products {flop / 1e9:.1f} GFLOP at "
          f"989 TFLOP/s bf16 -> {flop / PEAK_BF16_FLOPS * 1e3:.3f} ms); "
          f"the pair executes {pair_flop / 1e9:.1f} GFLOP (7 N^2 D multiply-adds per (b, h)) "
          f"-> {pair_flop / PEAK_BF16_FLOPS * 1e3:.3f} ms", flush=True)
    if not ok:
        print(f"exp_attn_bwd: the pair differs from the base beyond {TOL}", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
