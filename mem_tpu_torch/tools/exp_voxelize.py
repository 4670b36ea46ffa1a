"""Voxelizer kernel experiments X1a, X1b, X1c: the TPU's one-hot contraction
of the count planes, on the H100's tensor cores, beside the production K1.

Port of scripts/exp_voxelize.py. Its three Pallas bodies compute K1's
(B, H, 2W) planes [pos | neg] as onehot(ys)^T . onehot(col) on the matrix
unit; csrc/exp_voxelize.cu keeps that formulation on Hopper (bf16
mma.sync, f32 accumulators, one 64 x 128 output tile per block streaming all
of its sample's events), so the experiment asks the same question there:
what the contraction costs against K1's integer atomics, and what the
packing pass costs against reading the four raw arrays.

- X1a ``exp_voxelize_base``: from xs, ys, wpos, wneg (no ``pack_cols``);
  column x takes bf16(wpos), column W + x bf16(wneg).
- X1b ``exp_voxelize_fused_onehot``: from the packed col / ys of
  ``pack_cols``: K1's function, as f32.
- X1c ``exp_voxelize_fused_loop``: X1b with each chunk taken ``inner`` events
  at a time; ``inner`` must divide ``chunk`` (the reference drops every
  chunk's tail otherwise).

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise. On the card, run from the repo root::

    python -m mem_tpu_torch.tools.exp_voxelize [seg|cls|all]

It prints the card's name and power limit, then per shape (seg: B=8,
N=180,224, 440x640; cls: B=64, N=30,720, 256x256) one ``== name: ms -> Gev/s``
line per reference variant (base at chunk 2048; fused at 2048, 1024 and 4096;
loop at 8192 with inner 2048; the reference's ``_g8`` block group has no
counterpart here and is kept in the names only) and one for K1, each the
median of RUNS CUDA-event timings after WARMUP calls, on the reference's
seeded events. Each variant is first held bit for bit against its plain
version on the whole batch ("WRONG RESULT" and exit 1 otherwise). Without a
card it exits 2.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from mem_tpu_torch.kernels import count_launch
from mem_tpu_torch.ops.attention import MAX_SMEM_BYTES
from mem_tpu_torch.ops.voxelize_hist import hist_planes_cols, hist_planes_cols_reference
from mem_tpu_torch.tools import time_ms

RUNS, WARMUP = 10, 2
SHAPES = {"seg": (8, 180_224, 440, 640), "cls": (64, 30_720, 256, 256)}
# (variant, chunk, inner) in the reference's order (exp_voxelize.py:178-191)
VARIANTS = (("base", 2048, None), ("fused", 2048, None), ("fused", 1024, None),
            ("fused", 4096, None), ("loop", 8192, 2048))


def _check_stage(name: str, stage: int, words: int) -> None:
    """The kernel stages ``stage`` events of ``words`` int32 each in shared
    memory, 16 (one mma k-step) at a time."""
    if stage <= 0 or stage % 16:
        raise ValueError(f"{name}: chunk {stage} must be a positive multiple of 16")
    if stage * words * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: chunk {stage} needs {stage * words * 4} B of shared memory, "
                         f"above the {MAX_SMEM_BYTES} B a block may use")


def _check_cuda(name: str, tensors, dtypes) -> None:
    t0 = tensors[0]
    if t0.device.type != "cuda" or any(t.device != t0.device for t in tensors):
        raise ValueError(f"{name}: all operands must share one CUDA device")
    if any(t.dtype != d for t, d in zip(tensors, dtypes)):
        raise TypeError(f"{name} takes {dtypes}, got {[t.dtype for t in tensors]}")
    if t0.dim() != 2 or any(t.shape != t0.shape for t in tensors):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: all operands must be contiguous")


def exp_voxelize_base_reference(xs, ys, wpos, wneg, H: int, W: int) -> torch.Tensor:
    """Plain version of X1a: a scatter-add of bf16-rounded weights into f32
    (B, H, 2W) planes, wpos at column x, wneg at column W + x; events with x
    outside [0, W) or y outside [0, H) dropped."""
    B = xs.shape[0]
    ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    flat = torch.where(ok, ys.long() * (2 * W) + xs.long(), 0)
    out = torch.zeros(B, H * 2 * W, dtype=torch.float32, device=xs.device)
    for shift, wt in ((0, wpos), (W, wneg)):
        out.scatter_add_(1, flat + shift, torch.where(ok, wt.to(torch.bfloat16).float(), 0.0))
    return out.view(B, H, 2 * W)


def exp_voxelize_fused_reference(col, ys, H: int, W: int) -> torch.Tensor:
    """Plain version of X1b and X1c: K1's plain version, as f32."""
    return hist_planes_cols_reference(col, ys, H, W).float()


def exp_voxelize_base(xs, ys, wpos, wneg, H: int, W: int, chunk: int = 2048) -> torch.Tensor:
    """X1a: (B, N) int32 xs, ys and f32 wpos, wneg -> (B, H, 2W) f32 planes,
    staged ``chunk`` events at a time."""
    name = "exp_voxelize_base"
    _check_stage(name, chunk, 3)
    if xs.device.type == "cpu":
        return exp_voxelize_base_reference(xs, ys, wpos, wneg, H, W)
    _check_cuda(name, (xs, ys, wpos, wneg),
                (torch.int32, torch.int32, torch.float32, torch.float32))
    return _launch(name, "mem_exp_voxelize_base", (xs, ys, wpos, wneg), H, W, (chunk,))


def exp_voxelize_fused_onehot(col, ys, H: int, W: int, chunk: int = 2048) -> torch.Tensor:
    """X1b: (B, N) int32 packed col / ys -> (B, H, 2W) f32 count planes,
    staged ``chunk`` events at a time."""
    name = "exp_voxelize_fused_onehot"
    _check_stage(name, chunk, 2)
    if col.device.type == "cpu":
        return exp_voxelize_fused_reference(col, ys, H, W)
    _check_cuda(name, (col, ys), (torch.int32, torch.int32))
    return _launch(name, "mem_exp_voxelize_fused_onehot", (col, ys), H, W, (chunk,))


def exp_voxelize_fused_loop(col, ys, H: int, W: int, chunk: int = 8192,
                            inner: int = 2048) -> torch.Tensor:
    """X1c: X1b's function, each ``chunk`` consumed ``inner`` events at a
    time (on the card: staged ``inner`` events at a time). Raises ValueError
    unless ``inner`` divides ``chunk``."""
    name = "exp_voxelize_fused_loop"
    if inner <= 0 or chunk % inner:
        raise ValueError(f"{name}: inner {inner} does not divide chunk {chunk}")
    _check_stage(name, inner, 2)
    if col.device.type == "cpu":
        return exp_voxelize_fused_reference(col, ys, H, W)
    _check_cuda(name, (col, ys), (torch.int32, torch.int32))
    # X1b's launch, staged inner events at a time
    return _launch(name, "mem_exp_voxelize_fused_onehot", (col, ys), H, W, (inner,))


def _launch(name, entry, tensors, H, W, stage_args):
    """Launch the kernel at ``entry`` on ``tensors`` into new (B, H, 2W) f32
    planes and count the launch under ``name``."""
    from mem_tpu_torch.kernels import build

    B, N = tensors[0].shape
    lib = build.library()
    out = torch.empty(B, H, 2 * W, dtype=torch.float32, device=tensors[0].device)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = getattr(lib, entry)(*(t.data_ptr() for t in tensors), out.data_ptr(), B, N, H, W,
                             *stage_args, stream)
    build.check(name, rc)
    count_launch(name)
    return out


def make_events(B: int, N: int, H: int, W: int, device):
    """The reference's seeded events (exp_voxelize.py:93-96, 112-118), not
    padded: the kernels mask the ragged chunk. Returns (xs, ys, wpos, wneg,
    col, ys) on ``device``."""
    rng = np.random.default_rng(0)
    xs = rng.integers(0, W, (B, N)).astype(np.int32)
    ys = rng.integers(0, H, (B, N)).astype(np.int32)
    pol = rng.choice([0, 1], (B, N)).astype(np.int32)
    col = np.where(ys < H, xs + W * (1 - pol), 2 * W).astype(np.int32)
    arrays = (xs, ys, (pol == 1).astype(np.float32), (pol == 0).astype(np.float32), col, ys)
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def run_shape(tag: str, B: int, N: int, H: int, W: int) -> bool:
    """Every variant at one shape, then K1: checked, timed, printed. Returns
    whether every variant equals its plain version."""
    xs, ys, wpos, wneg, col, ysp = make_events(B, N, H, W, "cuda")
    want = exp_voxelize_fused_reference(col, ysp, H, W)
    want_base = exp_voxelize_base_reference(xs, ys, wpos, wneg, H, W)
    ok = True
    print(f"---- {tag}: B={B} N={N} {H}x{W} ----", flush=True)
    for variant, chunk, inner in VARIANTS:
        if variant == "base":
            name = f"{tag}_base_c{chunk}_g8"
            fn, ref = (lambda: exp_voxelize_base(xs, ys, wpos, wneg, H, W, chunk)), want_base
        elif variant == "fused":
            name = f"{tag}_fused_c{chunk}_g8"
            fn, ref = (lambda: exp_voxelize_fused_onehot(col, ysp, H, W, chunk)), want
        else:
            name = f"{tag}_loop_c{chunk}_g8_i{inner}"
            fn, ref = (lambda: exp_voxelize_fused_loop(col, ysp, H, W, chunk, inner)), want
        got = fn()
        if not torch.equal(got, ref):
            print(f"{name}: WRONG RESULT (max abs err "
                  f"{(got - ref).abs().max().item()})", flush=True)
            ok = False
            continue
        ms = time_ms(fn, RUNS, WARMUP)
        print(f"== {name}: {ms:.4f} ms -> {B * N / ms / 1e6:.3f} Gev/s", flush=True)
    # the production kernel, on the same packed events
    ms = time_ms(lambda: hist_planes_cols(col, ysp, H, W), RUNS, WARMUP)
    print(f"== {tag}_k1: {ms:.4f} ms -> {B * N / ms / 1e6:.3f} Gev/s "
          f"(hist_planes_cols, csrc/voxelize_hist.cu)", flush=True)
    return ok


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    which = argv[0] if argv else "seg"
    if which not in ("seg", "cls", "all"):
        print(f"exp_voxelize: unknown shape set {which!r} (seg, cls or all)", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("exp_voxelize: no CUDA device is available; the experiment runs on the card only",
              file=sys.stderr)
        return 2
    from mem_tpu_torch.utils.env import nvidia_smi

    print(nvidia_smi() or torch.cuda.get_device_name(0), flush=True)
    ok = True
    for tag in ("seg", "cls"):
        if which in (tag, "all"):
            ok &= run_shape(tag, *SHAPES[tag])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
