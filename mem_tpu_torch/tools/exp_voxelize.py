"""Voxelizer kernel experiments X1a, X1b, X1c: the TPU's one-hot contraction
of the count planes, on the H100's tensor cores, beside the production K1.

Port of scripts/exp_voxelize.py. Its three Pallas bodies compute K1's
(B, H, 2W) planes [pos | neg] as onehot(ys)^T . onehot(col) on the matrix
unit; csrc/exp_voxelize.cu keeps that formulation on Hopper (bf16 wgmma
with f32 accumulators, one 64-row x 2N-column output tile per block streaming
all of its sample's events through a ring of bulk copies, the one-hot
operands written sparsely into shared memory; :func:`x1_plan` picks N), so
the experiment asks the same question there: what the contraction costs
against K1, and what the packing pass costs against reading the four raw
arrays.

- X1a ``exp_voxelize_base``: from xs, ys, wpos, wneg (no ``pack_cols``);
  column x takes bf16(wpos), column W + x bf16(wneg).
- X1b ``exp_voxelize_fused_onehot``: from the packed col / ys of
  ``pack_cols``: K1's function, as f32.
- X1c ``exp_voxelize_fused_loop``: X1b with each chunk taken ``inner`` events
  at a time; ``inner`` must divide ``chunk`` (the reference drops every
  chunk's tail otherwise).

``chunk`` (X1c: ``inner``) is the events of one stage of the kernel's event
ring: a positive multiple of the 64-event slot whose two stages fit a block's
shared memory beside the one-hot rings (:func:`x1_smem`). The reference's
sweep (X1a 2048; X1b 1024, 2048, 4096; X1c 8192 with inner 2048) fits; X1b
above 4160 and X1a above 2048 do not. The operands must be 16-byte aligned
(the ring's bulk copies), as every tensor PyTorch allocates is.

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise. On the card, run from the repo root::

    python -m mem_tpu_torch.tools.exp_voxelize [seg|cls|all|tiles]

It prints the card's name and power limit, then per shape (seg: B=8,
N=180,224, 440x640; cls: B=64, N=30,720, 256x256) one ``== name: ms -> Gev/s``
line per reference variant (base at chunk 2048; fused at 2048, 1024 and 4096;
loop at 8192 with inner 2048; the reference's ``_g8`` block group has no
counterpart here and is kept in the names only) and one for K1, each the
median of RUNS CUDA-event timings after WARMUP calls, on the reference's
seeded events. Each variant is first held bit for bit against its plain
version on the whole batch ("WRONG RESULT" and exit 1 otherwise). ``tiles``
instead times X1b (chunk 2048) and X1a at both shapes with each tile width
of X1_TILE_NS, the plan's and the other: the device time per launch from
torch.profiler and its share of the contraction's time at the bf16 peak, one
``== tiles`` line each, after the same check. Without a card it exits 2.
"""
from __future__ import annotations

import functools
import sys
from typing import NamedTuple

import numpy as np
import torch

from mem_tpu_torch.kernels import count_launch
from mem_tpu_torch.ops.attention import MAX_SMEM_BYTES
from mem_tpu_torch.ops.voxelize_hist import (H100_SMS, hist_planes_cols,
                                             hist_planes_cols_reference, sm_count)
from mem_tpu_torch.tools import device_ms, time_ms

RUNS, WARMUP = 10, 2
SHAPES = {"seg": (8, 180_224, 440, 640), "cls": (64, 30_720, 256, 256)}
# (variant, chunk, inner) in the reference's order (exp_voxelize.py:178-191)
VARIANTS = (("base", 2048, None), ("fused", 2048, None), ("fused", 1024, None),
            ("fused", 4096, None), ("loop", 8192, 2048))


# the launch limits of csrc/exp_voxelize.cu
X1_ROWS = 64               # a block's rows (kRows): wgmma's m
X1_DEPTH = 64              # events of a one-hot slot (kDepth)
X1_SLOTS = 4               # slots of the one-hot ring (kSlots)
X1_TILE_NS = (128, 96)     # the columns of each of a block's two warpgroups (wgmma's n)


class X1Plan(NamedTuple):
    """One launch of X1's kernel: blocks of two warpgroups, one an SM, each
    owning a ``X1_ROWS`` x ``2 * tile_n`` tile of one sample's plane; the
    grid is (column tiles, row tiles, B) and runs in ``waves`` on ``sms``
    SMs."""
    tile_n: int
    grid: tuple
    blocks: int
    waves: int
    sms: int


@functools.lru_cache(maxsize=256)
def x1_plan(B: int, H: int, W: int, sms: int = H100_SMS) -> X1Plan:
    """The launch at (B, H, 2W) on a card of ``sms`` SMs: of the tile widths
    in X1_TILE_NS, the one whose waves take the least time, waves x tile_n
    (every block streams the same events, so a block's time goes with its
    width); the wider on a tie. At the seg shape (8, 440, 1280) N = 96: 392
    blocks in 3 waves (N = 128: 280 in 3); at cls (64, 256, 512) N = 128: 512
    in 4 (N = 96: 768 in 6)."""
    if min(B, H, W, sms) < 1:
        raise ValueError(f"x1_plan: B, H, W and sms must be positive: {(B, H, W, sms)}")
    plans = []
    for tile_n in X1_TILE_NS:
        grid = (-(-2 * W // (2 * tile_n)), -(-H // X1_ROWS), B)
        blocks = grid[0] * grid[1] * grid[2]
        plans.append(X1Plan(tile_n, grid, blocks, -(-blocks // sms), sms))
    return min(plans, key=lambda p: p.waves * p.tile_n)


def x1_smem(words: int, stage: int) -> int:
    """Shared memory (bytes) of a launch at the widest tile staging ``stage``
    events of ``words`` int32 arrays: the alignment slack, the A and B rings,
    two event stages (each array with 4 words of slack for the aligned copy)
    and the mbarriers (csrc/exp_voxelize.cu smem_bytes)."""
    rings = X1_SLOTS * (X1_ROWS * X1_DEPTH * 2 + 2 * max(X1_TILE_NS) * X1_DEPTH * 2)
    return 1024 + rings + 2 * words * (stage + 4) * 4 + 16 * (2 + X1_SLOTS)


def _check_stage(name: str, stage: int, words: int) -> None:
    """The kernel streams ``stage`` events of ``words`` int32 arrays a ring
    stage, 64 (one one-hot slot) at a time, in two stages that fit a block's
    shared memory beside the one-hot rings of the widest tile."""
    if stage <= 0 or stage % X1_DEPTH:
        raise ValueError(f"{name}: chunk {stage} must be a positive multiple of {X1_DEPTH}")
    if x1_smem(words, stage) > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: chunk {stage} needs {x1_smem(words, stage)} B of shared "
                         f"memory, above the {MAX_SMEM_BYTES} B a block may use")


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
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: all operands must be 16-byte aligned (the bulk copies)")


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
    _check_stage(name, chunk, 4)
    if xs.device.type == "cpu":
        return exp_voxelize_base_reference(xs, ys, wpos, wneg, H, W)
    _check_cuda(name, (xs, ys, wpos, wneg),
                (torch.int32, torch.int32, torch.float32, torch.float32))
    return _launch(name, "mem_exp_voxelize_base", (xs, ys, wpos, wneg), H, W, chunk)


def exp_voxelize_fused_onehot(col, ys, H: int, W: int, chunk: int = 2048) -> torch.Tensor:
    """X1b: (B, N) int32 packed col / ys -> (B, H, 2W) f32 count planes,
    staged ``chunk`` events at a time."""
    name = "exp_voxelize_fused_onehot"
    _check_stage(name, chunk, 2)
    if col.device.type == "cpu":
        return exp_voxelize_fused_reference(col, ys, H, W)
    _check_cuda(name, (col, ys), (torch.int32, torch.int32))
    return _launch(name, "mem_exp_voxelize_fused_onehot", (col, ys), H, W, chunk)


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
    return _launch(name, "mem_exp_voxelize_fused_onehot", (col, ys), H, W, inner)


def _launch(name, entry, tensors, H, W, stage, tile_n=None):
    """Launch the kernel at ``entry`` on ``tensors`` into new (B, H, 2W) f32
    planes, ``stage`` events a ring stage, tiled by :func:`x1_plan` (or at
    ``tile_n``, for ``tiles``), and count the launch under ``name``."""
    from mem_tpu_torch.kernels import build

    B, N = tensors[0].shape
    dev = tensors[0].device
    lib = build.library(dev)
    plan = x1_plan(B, H, W, sm_count(dev.index))
    out = torch.empty(B, H, 2 * W, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = getattr(lib, entry)(*(t.data_ptr() for t in tensors), out.data_ptr(), B, N, H, W,
                             stage, tile_n or plan.tile_n, stream)
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


def run_tiles() -> bool:
    """X1b and X1a at seg and cls with each tile width: checked, then device
    ms and the share of the contraction bound."""
    from mem_tpu_torch.tools import PEAK_BF16_FLOPS

    ok = True
    for tag, (B, N, H, W) in SHAPES.items():
        xs, ys, wpos, wneg, col, ysp = make_events(B, N, H, W, "cuda")
        want = {"exp_voxelize_fused_onehot": exp_voxelize_fused_reference(col, ysp, H, W),
                "exp_voxelize_base": exp_voxelize_base_reference(xs, ys, wpos, wneg, H, W)}
        t_flop = 2 * B * N * H * 2 * W / PEAK_BF16_FLOPS * 1e3
        for tile_n in X1_TILE_NS:
            for name, entry, tensors in (
                    ("exp_voxelize_fused_onehot", "mem_exp_voxelize_fused_onehot", (col, ysp)),
                    ("exp_voxelize_base", "mem_exp_voxelize_base", (xs, ys, wpos, wneg))):
                def fn():
                    return _launch(name, entry, tensors, H, W, 2048, tile_n)

                if not torch.equal(fn(), want[name]):
                    print(f"{tag} {name} tile_n {tile_n}: WRONG RESULT", flush=True)
                    ok = False
                    continue
                ms = device_ms(fn, ("x1_wgmma_kernel",))
                print(f"== tiles {tag} {name} tile_n {tile_n} (plan {x1_plan(B, H, W).tile_n}): "
                      f"{ms:.4f} ms device -> {t_flop / ms:.3f} of the bf16 peak", flush=True)
    return ok


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    which = argv[0] if argv else "seg"
    if which not in ("seg", "cls", "all", "tiles"):
        print(f"exp_voxelize: unknown shape set {which!r} (seg, cls, all or tiles)",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("exp_voxelize: no CUDA device is available; the experiment runs on the card only",
              file=sys.stderr)
        return 2
    from mem_tpu_torch.utils.env import nvidia_smi

    print(nvidia_smi() or torch.cuda.get_device_name(0), flush=True)
    if which == "tiles":
        return 0 if run_tiles() else 1
    ok = True
    for tag in ("seg", "cls"):
        if which in (tag, "all"):
            ok &= run_shape(tag, *SHAPES[tag])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
