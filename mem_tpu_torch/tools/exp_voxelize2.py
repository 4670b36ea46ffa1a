"""Voxelizer kernel experiments X2a, X2b, X2c: y-sorted events and a row-band
accumulator that skips the (band, chunk) pairs a chunk's rows miss (the
algorithmic cut of the one-hot contraction), its int8 variant, and the cost
of the packed-key sort, on the H100 beside the production K1 and K4.

Port of scripts/exp_voxelize2.py. Its three Pallas bodies are kept as the
one-hot contraction on the tensor cores (csrc/exp_voxelize2.cu): one wgmma
kernel template, X1's design (exp_voxelize.cu) in int8 and bf16. A block
owns a tile of one sample's plane, a producer warp streams the events it
consumes through a ring of bulk copies, two builder warpgroups write each
event's one-hot values sparsely into swizzled shared-memory slots (and zero
them again), two consumer warpgroups run the products; each output cell is
written once, from registers. A block's tile is 64 rows (wgmma's m) x 2N
columns; :func:`x2_plan` picks N = 96 or 128 (a slot holds two 128-byte
K-blocks of events at N = 96, one at N = 128).

- X2a ``exp_voxelize2_fused_i8``: X1b's dense contraction with int8
  one-hots and int32 sums (wgmma m64nNk32.s32.s8.s8, 128 events a 128-byte
  K-block): K1's (B, H, 2W) function as int32. ``chunk`` is the events of
  one ring stage: a positive multiple of the K-block whose two stages fit a
  block's shared memory beside the one-hot rings (:func:`x2_smem`; up to
  4096).
- X2b ``exp_voxelize2_tiled``: bands of TH rows (a positive multiple of 32);
  a band computes a chunk of ``chunk`` events only when the chunk's
  [min ys, max ys] meets it, the reference's test, exact for any event
  order. bf16 one-hots (m64nNk16, 64 events a K-block), f32 sums; output (B,
  n_tiles * TH, 2W), n_tiles = ceil(H / TH), whose rows H <= y < n_tiles * TH
  count too (the reference crops [:, :H]). A bounds pass writes each chunk's
  min and max of ys; each block then walks only the chunks that meet the
  bands its rows span (:func:`kept_pairs`), decided before any event is
  staged. At TH = 32 a 64-row tile takes the union of its two bands. ``chunk``
  is the skip's grain alone, a positive multiple of the K-block: a kept
  chunk is staged X2_STAGE_CAP events at a time, so every chunk of the
  reference's sweeps fits (X2b's 8192 included).
- X2c ``exp_voxelize2_tiled_i8``: X2b in int8 with int32 sums; ``chunk`` a
  positive multiple of 128.

The operands must be 16-byte aligned (the ring's bulk copies), as every
tensor PyTorch allocates is; the kernels mask the ragged last chunk, so
nothing is padded.

The packed-key sort ``sort_packed`` (key = ys * 4096 + col, one sort per
sample, split back by floor division and modulo) is ``jnp.sort`` in the
reference, XLA's own and outside any Pallas kernel; here it is ``torch.sort``
on the int32 key, no kernel of the port's. ``e2e_sort_tiled`` is the
reference's ``e2e``: the sort, then X2b or X2c.

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise. On the card, run from the repo root::

    python -m mem_tpu_torch.tools.exp_voxelize2 [main|main2|main3|all|tiles]

``main`` (the reference's ``__main__``) times the sort, X2a unsorted at chunk
2048 and X2b on sorted events at (TH, chunk) in (128, 2048), (128, 4096),
(64, 2048), (128, 8192), K4 on the same sorted events, then the sort and X2b
(128, 4096) from unsorted events; ``main2`` X2b at (32, 2048), (64, 1024),
X2c at (64, 2048), (32, 2048), (64, 1024) and the sort with X2c (64, 2048);
``main3`` the classification shape (B=64, N=30,720, 256x256): X2a at chunk
2048 and 4096 and the production K1. It prints the card's name and power
limit, then one ``== name: ms -> Gev/s`` line per variant under the
reference's names, each the median of RUNS CUDA-event timings after WARMUP
calls, on the reference's seeded events (B=8, N=180,224, 440x640). Each
variant is first held bit for bit against its plain version on the whole
batch ("WRONG RESULT" and exit 1 otherwise). ``tiles`` instead times both
tile widths of X2_TILE_NS, the plan's and the other: X2a at seg and cls, and
X2b / X2c at every (TH, chunk) of their sweeps on sorted events: device ms
per call (the bounds pass included) from torch.profiler and the share of
the contraction's time at the dtype's peak, one ``== tiles`` line each,
after the same check. Without a card it exits 2.
"""
from __future__ import annotations

import functools
import sys
from typing import NamedTuple

import numpy as np
import torch

from mem_tpu_torch.kernels import count_launch
from mem_tpu_torch.ops.attention import MAX_SMEM_BYTES
from mem_tpu_torch.ops.voxelize_hist import (H100_SMS, KEY_COLS, _check_cuda_events,
                                             hist_planes_cols_reference,
                                             hist_planes_cols_sorted, pack_cols, sm_count,
                                             voxelize_planes)
from mem_tpu_torch.tools import device_ms, time_ms

RUNS, WARMUP = 10, 2
SEG = (8, 180_224, 440, 640)   # exp_voxelize2.py:21
CLS = (64, 30_720, 256, 256)   # main3, exp_voxelize2.py:277
# (dtype, TH, chunk) of the reference's sweeps, in its order
MAIN_TILED = (("bf16", 128, 2048), ("bf16", 128, 4096), ("bf16", 64, 2048), ("bf16", 128, 8192))
MAIN_E2E = ("bf16", 128, 4096)
MAIN2_TILED = (("bf16", 32, 2048), ("bf16", 64, 1024), ("i8", 64, 2048), ("i8", 32, 2048),
               ("i8", 64, 1024))
MAIN2_E2E = ("i8", 64, 2048)
MAIN_DENSE_CHUNK = 2048
CLS_DENSE_CHUNKS = (2048, 4096)

# the launch limits of csrc/exp_voxelize2.cu
BAND_ROWS = 32             # TH is a positive multiple of it
X2_DEPTH = {"bf16": 64, "i8": 128}   # events of a one-hot K-block: one 128-byte row
X2_ROWS = 64               # a block's rows (kRows): wgmma's m
X2_RING = 4                # 128-byte K-blocks of the one-hot ring (two slots at N = 96)
X2_TILE_NS = (128, 96)     # the columns of each of a block's two warpgroups (wgmma's n)
X2_STAGE_CAP = 4096        # events of a ring stage of the tiled kernels


def n_rows(H: int, TH: int) -> int:
    """Rows of the tiled output: n_tiles * TH, n_tiles = ceil(H / TH)."""
    return -(-H // TH) * TH


class X2Plan(NamedTuple):
    """One launch of X2's kernel: blocks of two consumer warpgroups, one an
    SM, each owning an X2_ROWS x ``2 * tile_n`` tile of one sample's plane;
    the grid is (column tiles, row tiles, B) and runs in ``waves`` on ``sms``
    SMs. ``stage`` is the events of a ring stage."""
    tile_n: int
    grid: tuple
    blocks: int
    waves: int
    sms: int
    stage: int


def _plans(B, rows, W, sms, stage):
    """The launch at each tile width of X2_TILE_NS."""
    for tile_n in X2_TILE_NS:
        grid = (-(-2 * W // (2 * tile_n)), -(-rows // X2_ROWS), B)
        blocks = grid[0] * grid[1] * grid[2]
        yield X2Plan(tile_n, grid, blocks, -(-blocks // sms), sms, stage)


@functools.lru_cache(maxsize=256)
def x2_plan(B: int, H: int, W: int, TH: int | None = None, chunk: int = MAIN_DENSE_CHUNK,
            sms: int = H100_SMS) -> X2Plan:
    """The launch at (B, H, 2W) on a card of ``sms`` SMs: X2a (``TH`` None,
    rows = H, a stage of ``chunk`` events) or X2b / X2c (rows = n_tiles * TH,
    stages of min(chunk, X2_STAGE_CAP) events), at the tile width of
    X2_TILE_NS whose waves take the least time, waves x tile_n (x1_plan's
    rule); the wider on a tie."""
    if min(B, H, W, sms) < 1 or (TH is not None and TH < 1):
        raise ValueError(f"x2_plan: B, H, W, TH and sms must be positive: {(B, H, W, TH, sms)}")
    rows = H if TH is None else n_rows(H, TH)
    stage = chunk if TH is None else min(chunk, X2_STAGE_CAP)
    return min(_plans(B, rows, W, sms, stage), key=lambda p: p.waves * p.tile_n)


def x2_smem(tile_n: int, stage: int) -> int:
    """Shared memory (bytes) of a launch: the alignment slack, the A and B
    rings (X2_RING K-blocks of 128-byte rows: A X2_ROWS, B 2 tile_n), two
    event stages of col and ys (each with 4 words of slack for the aligned
    copy) and the mbarriers (csrc/exp_voxelize2.cu smem_bytes)."""
    return (1024 + X2_RING * (X2_ROWS + 2 * tile_n) * 128 + 2 * 2 * (stage + 4) * 4
            + 16 * (2 + X2_RING))


def _check_args(name: str, col, ys, chunk: int, dtype: str, TH: int | None = None) -> None:
    """What every device asks of the arguments: int32 (B, N) events of one
    shape, a chunk that is a positive multiple of the one-hot K-block (64
    events in bf16, 128 in int8) and, for X2a (no TH), whose two stages fit
    a block's shared memory at the widest tile, a TH that is a positive
    multiple of 32."""
    if col.dtype != torch.int32 or ys.dtype != torch.int32:
        raise ValueError(f"{name} takes int32 col and ys, got {col.dtype} / {ys.dtype}")
    if col.dim() != 2 or col.shape != ys.shape:
        raise ValueError(f"{name}: shapes {tuple(col.shape)} vs {tuple(ys.shape)}")
    depth = X2_DEPTH[dtype]
    if chunk <= 0 or chunk % depth:
        raise ValueError(f"{name}: chunk {chunk} must be a positive multiple of {depth}")
    if TH is None and x2_smem(max(X2_TILE_NS), chunk) > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: chunk {chunk} needs {x2_smem(max(X2_TILE_NS), chunk)} B of "
                         f"shared memory, above the {MAX_SMEM_BYTES} B a block may use")
    if TH is not None and (TH <= 0 or TH % BAND_ROWS):
        raise ValueError(f"{name}: TH {TH} must be a positive multiple of {BAND_ROWS}")


def chunk_bounds(ys, chunk: int) -> torch.Tensor:
    """Plain version of the kernels' bounds pass: (B, ceil(N / chunk), 2)
    int32, min and max of ys over each chunk of each sample (the ragged last
    chunk over its own events; invalid values included)."""
    B, N = ys.shape
    pad = -(-N // chunk) * chunk - N
    info = torch.iinfo(torch.int32)
    lo = torch.nn.functional.pad(ys, (0, pad), value=info.max).view(B, -1, chunk).amin(2)
    hi = torch.nn.functional.pad(ys, (0, pad), value=info.min).view(B, -1, chunk).amax(2)
    return torch.stack([lo, hi], -1)


def kept_pairs(bounds, rows: int, TH: int, tile_rows: int) -> torch.Tensor:
    """(B, ceil(rows / tile_rows), n_chunks) bool: the (tile, chunk) pairs a
    tiled kernel consumes, from the bounds table. A tile of ``tile_rows``
    rows walks a chunk when the chunk's [min ys, max ys] meets the rows of
    the bands it spans, the union of the reference's per-band tests; with
    tile_rows = TH it is the reference's (band, chunk) test itself."""
    r0 = torch.arange(0, rows, tile_rows)
    lo = r0 // TH * TH
    hi = -(-torch.clamp(r0 + tile_rows, max=rows) // TH) * TH
    return ((bounds[..., 1][:, None, :] >= lo[None, :, None])
            & (bounds[..., 0][:, None, :] < hi[None, :, None]))


def exp_voxelize2_fused_i8_reference(col, ys, H: int, W: int) -> torch.Tensor:
    """Plain version of X2a: K1's plain version, (B, H, 2W) int32."""
    return hist_planes_cols_reference(col, ys, H, W)


def exp_voxelize2_tiled_reference(col, ys, H: int, W: int, TH: int,
                                  dtype=torch.float32) -> torch.Tensor:
    """Plain version of X2b (f32) and X2c (int32): a scatter-add of ones into
    (B, n_tiles * TH, 2W) over rows [0, n_tiles * TH) and columns [0, 2W)."""
    return hist_planes_cols_reference(col, ys, n_rows(H, TH), W).to(dtype)


def exp_voxelize2_fused_i8(col, ys, H: int, W: int, chunk: int = 2048) -> torch.Tensor:
    """X2a: (B, N) int32 packed col / ys -> (B, H, 2W) int32 count planes,
    staged ``chunk`` events at a time."""
    name = "exp_voxelize2_fused_i8"
    _check_args(name, col, ys, chunk, "i8")
    if col.device.type == "cpu":
        return exp_voxelize2_fused_i8_reference(col, ys, H, W)
    return _launch(name, "mem_exp_voxelize2_fused_i8", col, ys, H, W, "i8", None, chunk)


def exp_voxelize2_tiled(col, ys, H: int, W: int, TH: int, chunk: int) -> torch.Tensor:
    """X2b: (B, N) int32 col / ys -> (B, n_tiles * TH, 2W) f32 count planes
    by bands of TH rows, skipping the chunks of ``chunk`` events whose y range
    misses a band (bf16 one-hots)."""
    name = "exp_voxelize2_tiled"
    _check_args(name, col, ys, chunk, "bf16", TH)
    if col.device.type == "cpu":
        return exp_voxelize2_tiled_reference(col, ys, H, W, TH)
    return _launch(name, "mem_exp_voxelize2_tiled", col, ys, H, W, "bf16", TH, chunk)


def exp_voxelize2_tiled_i8(col, ys, H: int, W: int, TH: int, chunk: int) -> torch.Tensor:
    """X2c: X2b with int8 one-hots -> (B, n_tiles * TH, 2W) int32."""
    name = "exp_voxelize2_tiled_i8"
    _check_args(name, col, ys, chunk, "i8", TH)
    if col.device.type == "cpu":
        return exp_voxelize2_tiled_reference(col, ys, H, W, TH, torch.int32)
    return _launch(name, "mem_exp_voxelize2_tiled_i8", col, ys, H, W, "i8", TH, chunk)


def _launch(name, entry, col, ys, H, W, dtype, TH, chunk, plan=None):
    """Launch the kernel at ``entry`` into new planes (tiled when TH is
    given, with its bounds scratch) on :func:`x2_plan`'s tiling (or
    ``plan``'s, for ``tiles``) and count the launch under ``name``."""
    from mem_tpu_torch.kernels import build

    _check_cuda_events(name, col, ys)
    if col.data_ptr() % 16 or ys.data_ptr() % 16:
        raise ValueError(f"{name}: col and ys must be 16-byte aligned (the bulk copies)")
    B, N = col.shape
    lib = build.library(col.device)
    plan = plan or x2_plan(B, H, W, TH, chunk, sm_count(col.device.index))
    rows = H if TH is None else n_rows(H, TH)
    out = torch.empty(B, rows, 2 * W, dtype=torch.float32 if dtype == "bf16" else torch.int32,
                      device=col.device)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    if TH is None:
        rc = getattr(lib, entry)(col.data_ptr(), ys.data_ptr(), out.data_ptr(), B, N, H, W,
                                 chunk, plan.tile_n, stream)
    else:
        bounds = torch.empty(B, max(-(-N // chunk), 1), 2, dtype=torch.int32,
                             device=col.device)
        rc = getattr(lib, entry)(col.data_ptr(), ys.data_ptr(), out.data_ptr(),
                                 bounds.data_ptr(), B, N, H, W, TH, chunk, plan.stage,
                                 plan.tile_n, stream)
    build.check(name, rc)
    count_launch(name)
    return out


def sort_packed(col, ys):
    """The reference's packed-key sort (exp_voxelize2.py:104-109): key =
    ys * 4096 + col (int32), sorted per sample, split by floor division and
    modulo. Returns (col, ys) sorted by y, then by col."""
    key = torch.sort(ys * KEY_COLS + col, dim=1).values
    return torch.remainder(key, KEY_COLS), torch.div(key, KEY_COLS, rounding_mode="floor")


def e2e_sort_tiled(col, ys, H: int, W: int, TH: int, chunk: int, int8: bool = False):
    """The reference's ``e2e``: ``sort_packed``, then X2c (``int8``) or X2b
    on the sorted events."""
    if 2 * W >= KEY_COLS:
        raise ValueError(f"e2e_sort_tiled: 2W = {2 * W} does not fit the 12 bits the "
                         f"packed key keeps for the column")
    c, y = sort_packed(col, ys)
    c, y = c.contiguous(), y.contiguous()
    return (exp_voxelize2_tiled_i8 if int8 else exp_voxelize2_tiled)(c, y, H, W, TH, chunk)


def make_inputs(B: int, N: int, H: int, W: int, sort: bool, device):
    """The reference's seeded events (exp_voxelize2.py:65-77), not padded:
    (col, ys) on ``device``, y-sorted per sample (stable) with ``sort``."""
    rng = np.random.default_rng(0)
    xs = rng.integers(0, W, (B, N)).astype(np.int32)
    ys = rng.integers(0, H, (B, N)).astype(np.int32)
    pol = rng.choice([0, 1], (B, N)).astype(np.int32)
    col = (xs + W * (1 - pol)).astype(np.int32)
    if sort:
        order = np.argsort(ys, axis=1, kind="stable")
        ys = np.take_along_axis(ys, order, axis=1)
        col = np.take_along_axis(col, order, axis=1)
    return torch.from_numpy(col).to(device), torch.from_numpy(ys).to(device)


def _variant(name: str, fn, want, events: int) -> bool:
    """Hold ``fn()`` to ``want`` bit for bit, then time it and print its line."""
    got = fn()
    if not torch.equal(got, want):
        print(f"{name}: WRONG RESULT (max abs err "
              f"{(got.double() - want.double()).abs().max().item()})", flush=True)
        return False
    ms = time_ms(fn, RUNS, WARMUP)
    print(f"== {name}: {ms:.4f} ms -> {events / ms / 1e6:.3f} Gev/s", flush=True)
    return True


def _run_tiled(sweep, col, ys, H, W, tagged) -> bool:
    """X2b / X2c at each (dtype, TH, chunk) of ``sweep``, named as the
    reference names them (main2 ``tagged`` with the dtype)."""
    ok = True
    for dt, TH, chunk in sweep:
        fn = exp_voxelize2_tiled_i8 if dt == "i8" else exp_voxelize2_tiled
        want = exp_voxelize2_tiled_reference(col, ys, H, W, TH,
                                             torch.int32 if dt == "i8" else torch.float32)
        name = f"sorted_tiled_{dt}_t{TH}_c{chunk}" if tagged else f"sorted_tiled_t{TH}_c{chunk}"
        ok &= _variant(name, lambda: fn(col, ys, H, W, TH, chunk), want, col.numel())
    return ok


def _run_e2e(name, spec, col, ys, H, W) -> bool:
    """The sort and the tiled kernel from unsorted events, against the plain
    version of the same composition."""
    dt, TH, chunk = spec
    c, y = sort_packed(col, ys)
    want = exp_voxelize2_tiled_reference(c, y, H, W, TH,
                                         torch.int32 if dt == "i8" else torch.float32)
    return _variant(name, lambda: e2e_sort_tiled(col, ys, H, W, TH, chunk, dt == "i8"), want,
                    col.numel())


def run_main() -> bool:
    """The reference's ``main`` at the seg shape."""
    B, N, H, W = SEG
    col, ys = make_inputs(B, N, H, W, False, "cuda")
    print(f"---- main: B={B} N={N} {H}x{W} ----", flush=True)
    ms = time_ms(lambda: sort_packed(col, ys), RUNS, WARMUP)
    print(f"== onchip_sort(8x180k): {ms:.4f} ms -> {B * N / ms / 1e6:.3f} Gev/s", flush=True)
    ok = _variant("int8_dense", lambda: exp_voxelize2_fused_i8(col, ys, H, W, MAIN_DENSE_CHUNK),
                  exp_voxelize2_fused_i8_reference(col, ys, H, W), B * N)
    cols, yss = make_inputs(B, N, H, W, True, "cuda")
    ok &= _run_tiled(MAIN_TILED, cols, yss, H, W, tagged=False)
    # the production K4 on the same sorted events
    ok &= _variant("sorted_k4_presorted",
                   lambda: hist_planes_cols_sorted(cols, yss, H, W, presorted=True),
                   hist_planes_cols_reference(cols, yss, H, W), B * N)
    return ok & _run_e2e("e2e_sort_tiled", MAIN_E2E, col, ys, H, W)


def run_main2() -> bool:
    """The reference's ``main2`` at the seg shape."""
    B, N, H, W = SEG
    col, ys = make_inputs(B, N, H, W, False, "cuda")
    cols, yss = make_inputs(B, N, H, W, True, "cuda")
    print(f"---- main2: B={B} N={N} {H}x{W} ----", flush=True)
    ok = _run_tiled(MAIN2_TILED, cols, yss, H, W, tagged=True)
    dt, TH, chunk = MAIN2_E2E
    return ok & _run_e2e(f"e2e_sort_tiled_{dt}_t{TH}_c{chunk}", MAIN2_E2E, col, ys, H, W)


def run_main3() -> bool:
    """The reference's ``main3``: X2a at the classification shape, and the
    production K1 (``voxelize_planes`` packs and routes this canvas to K1) on
    the reference's own draws of raw events."""
    B, N, H, W = CLS
    col, ys = make_inputs(B, N, H, W, False, "cuda")
    print(f"---- main3: B={B} N={N} {H}x{W} ----", flush=True)
    want = exp_voxelize2_fused_i8_reference(col, ys, H, W)
    ok = True
    for chunk in CLS_DENSE_CHUNKS:
        ok &= _variant(f"cls_int8_dense_c{chunk}",
                       lambda: exp_voxelize2_fused_i8(col, ys, H, W, chunk), want, B * N)
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.integers(0, W, (B, N)).astype(np.int32)).cuda()
    ys2 = torch.from_numpy(rng.integers(0, H, (B, N)).astype(np.int32)).cuda()
    wp = torch.from_numpy((rng.random((B, N)) < 0.5).astype(np.float32)).cuda()
    wn = 1.0 - wp
    want = hist_planes_cols_reference(*pack_cols(xs, ys2, wp, wn, H, W), H, W)
    return ok & _variant("cls_prod_current", lambda: voxelize_planes(xs, ys2, wp, wn, H, W),
                         want, B * N)


def run_tiles() -> bool:
    """X2a at seg and cls, X2b and X2c at every (TH, chunk) of their sweeps
    on sorted seg events, each at both tile widths: checked, then device ms
    and the share of the contraction bound at the dtype's peak (X2a: every
    event enters every tile; X2b / X2c: the 64-row tiles' kept pairs)."""
    from mem_tpu_torch.tools import PEAK_BF16_FLOPS, PEAK_INT8_OPS

    peak = {"bf16": PEAK_BF16_FLOPS, "i8": PEAK_INT8_OPS}
    entries = {"bf16": ("exp_voxelize2_tiled", "mem_exp_voxelize2_tiled"),
               "i8": ("exp_voxelize2_tiled_i8", "mem_exp_voxelize2_tiled_i8")}
    cases = [("seg", SEG, False, ("i8", None, MAIN_DENSE_CHUNK)),
             ("cls", CLS, False, ("i8", None, CLS_DENSE_CHUNKS[-1]))]
    cases += [("seg_sorted", SEG, True, spec) for spec in dict.fromkeys(
        MAIN_TILED + MAIN2_TILED)]
    ok, events = True, {}
    for tag, (B, N, H, W), sort, (dt, TH, chunk) in cases:
        if tag not in events:
            events = {tag: make_inputs(B, N, H, W, sort, "cuda")}
        col, ys = events[tag]
        if TH is None:
            name, entry = "exp_voxelize2_fused_i8", "mem_exp_voxelize2_fused_i8"
            want = exp_voxelize2_fused_i8_reference(col, ys, H, W)
            work, rows = 2 * B * N * H * 2 * W, H
        else:
            name, entry = entries[dt]
            want = exp_voxelize2_tiled_reference(
                col, ys, H, W, TH, torch.float32 if dt == "bf16" else torch.int32)
            rows = n_rows(H, TH)
            kept = kept_pairs(chunk_bounds(ys.cpu(), chunk), rows, TH, X2_ROWS)
            work = 2 * int(kept.sum()) * X2_ROWS * chunk * 2 * W
        planned = x2_plan(B, H, W, TH, chunk).tile_n
        for p in _plans(B, rows, W, H100_SMS, chunk if TH is None else min(chunk, X2_STAGE_CAP)):
            def fn():
                return _launch(name, entry, col, ys, H, W, dt, TH, chunk, p)

            label = f"{tag} {name} t{TH}_c{chunk} tile_n {p.tile_n}"
            if not torch.equal(fn(), want):
                print(f"{label}: WRONG RESULT", flush=True)
                ok = False
                continue
            ms = device_ms(fn, ("x2_wgmma_kernel", "chunk_minmax_kernel"))
            print(f"== tiles {label} (plan {planned}): {ms:.4f} ms device -> "
                  f"{work / peak[dt] * 1e3 / ms:.3f} of the {dt} peak", flush=True)
    return ok


RUNNERS = {"main": run_main, "main2": run_main2, "main3": run_main3}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    which = argv[0] if argv else "main"
    if which not in (*RUNNERS, "all", "tiles"):
        print(f"exp_voxelize2: unknown part {which!r} (main, main2, main3, all or tiles)",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("exp_voxelize2: no CUDA device is available; the experiment runs on the card only",
              file=sys.stderr)
        return 2
    from mem_tpu_torch.utils.env import nvidia_smi

    print(nvidia_smi() or torch.cuda.get_device_name(0), flush=True)
    if which == "tiles":
        return 0 if run_tiles() else 1
    ok = True
    for part, run in RUNNERS.items():
        if which in (part, "all"):
            ok &= run()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
