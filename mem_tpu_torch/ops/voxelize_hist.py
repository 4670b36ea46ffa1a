"""Event-count histogram planes: kernels K1 and K4 and their plain versions.

Port of mem_tpu/ops/voxelize_pallas.py. The TPU kernels build one-hot
factors in VMEM and contract them on the matrix unit; on Hopper the same
function is a scatter histogram into shared memory (csrc/voxelize_hist.cuh,
one body for both kernels). Inputs are the pre-packed per-event coordinates
of :func:`pack_cols`: col = x + W * (p < 0) in [0, 2W), 2W marks an invalid
event; ys in [0, H), H marks one.

- K1, ``hist_planes_cols`` (csrc/voxelize_hist.cu): any event order. A block
  counts a band of rows of one sample in shared memory, reading all of the
  sample's events.
- K4, ``hist_planes_cols_sorted`` (csrc/voxelize_hist_sorted.cu): for wide
  canvases. With events sorted by y, each band reads only the event chunks
  that meet it; unsorted events take K1's pass under K4's name (the counts
  do not depend on order), no sort.

Both write each output cell once, in one of two layouts: the (B, H, 2W)
int32 planes [pos | neg] (the port), or, with ``raster``, the (B, H, W, 3)
uint8 image of voxelize_fused without a time surface (:func:`raster_from_planes`
of the planes: the tail the reference leaves to XLA after its Pallas call).
:func:`hist_plan` sizes a launch: rows a block and blocks.

Routing (:func:`voxelize_planes`, its one home, voxelize_pallas.py:204-210):
canvases with H * 2W >= WIDE_CANVAS_CELLS (300,000 cells: DSEC 440x640 and
bin-folded ``--voxel`` canvases) whose column fits the 12 bits of the packed
sort key go to K4, every other canvas to K1.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from mem_tpu_torch.kernels import count_launch

WIDE_CANVAS_CELLS = 300_000   # voxelize_pallas.py:57
KEY_COLS = 4096               # the packed sort key keeps 12 bits for the column

# the launch limits of csrc/voxelize_hist.cuh and of the card
THREADS = 1024                # a block's threads (kThreads): 64 registers each, one block an SM
SMEM_LIMIT = 232_448          # shared memory one block may use (kMaxSmem)
HEADER_BYTES = 16             # shared memory ahead of the counters (kHeader)
CHUNK = 2048                  # events per bounds entry of K4's skip (kChunk)
NARROW_MAX_N = 65_535         # 16-bit counters hold every count of N <= this
H100_SMS = 132
MODES = {None: 0, True: 1, False: 2}   # planes; raster mod 256; raster min(., 255)


class HistPlan(NamedTuple):
    """One launch of the histogram body: blocks of THREADS threads, one an
    SM, each counting ``rows`` rows of the plane (its band) in shared memory
    with counters of ``counter_bytes``. The ``blocks`` (at most one an SM:
    ``waves`` == 1) walk the ``items`` = B * bands a sample in ``rounds``.
    ``skip``: K4's bounds pass and chunk skip."""
    counter_bytes: int
    rows: int
    blocks: int
    smem: int
    items: int
    rounds: int
    waves: int
    sms: int
    skip: bool


@functools.lru_cache(maxsize=256)   # a wrapper's host time at serving shapes: plan once
def hist_plan(B: int, N: int, H: int, W: int, sms: int = H100_SMS,
              skip: bool = False) -> HistPlan:
    """The launch of K1 / K4 at (B, N, H, W) on a card of ``sms`` SMs.

    Counters are 16 bits where N <= NARROW_MAX_N proves that no cell reaches
    65,536, else 32. Each block counts its band on its own, and the bands
    spread each sample over about ``sms / B`` blocks (at least the bands that
    fit SMEM_LIMIT), so the card fills in one wave. The grid holds at most
    one block an SM (``waves`` == 1): the blocks walk the items in
    ``rounds``. ``skip`` (K4 on sorted events) only records the launch's
    kind: a band then reads the chunks that meet it."""
    if min(B, H, W) < 1 or N < 0:
        raise ValueError(f"hist_plan: B, H, W must be positive, N >= 0: {(B, N, H, W)}")
    counter_bytes = 2 if N <= NARROW_MAX_N else 4
    row_bytes = 2 * W * counter_bytes
    fit = (SMEM_LIMIT - HEADER_BYTES) // row_bytes
    if fit < 1:
        raise ValueError(f"hist_plan: one row of 2W = {2 * W} counters does not fit "
                         f"{SMEM_LIMIT} bytes of shared memory")
    rows = -(-H // max(-(-H // fit), sms // B))   # <= fit
    items = B * -(-H // rows)
    blocks = min(items, sms)
    return HistPlan(counter_bytes, rows, blocks, HEADER_BYTES + rows * row_bytes, items,
                    -(-items // blocks), -(-blocks // sms), sms, skip)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def pack_cols(xs, ys, wpos, wneg, H: int, W: int):
    """Fold polarity + validity into (col, ys): positive events -> col in
    [0, W), negative -> [W, 2W), invalid -> sentinels (col 2W, ys H)."""
    valid = (wpos > 0) | (wneg > 0)
    col = torch.where(wpos > 0, xs, xs + W)
    col = torch.where(valid, col, torch.full_like(col, 2 * W)).to(torch.int32)
    ys = torch.where(valid, ys, torch.full_like(ys, H)).to(torch.int32)
    return col, ys


def hist_planes_cols_reference(col: torch.Tensor, ys: torch.Tensor,
                               H: int, W: int) -> torch.Tensor:
    """Plain version of K1: scatter-add of ones over ys * 2W + col, invalid
    events (col outside [0, 2W) or ys outside [0, H)) dropped.
    Returns (B, H, 2W) int32."""
    B = col.shape[0]
    ok = (col >= 0) & (col < 2 * W) & (ys >= 0) & (ys < H)
    flat = torch.where(ok, ys.long() * (2 * W) + col.long(), 0)
    out = torch.zeros(B, H * 2 * W, dtype=torch.int32, device=col.device)
    out.scatter_add_(1, flat, ok.to(torch.int32))
    return out.view(B, H, 2 * W)


def wrap_counts(planes: torch.Tensor, wrap_uint8: bool) -> torch.Tensor:
    """int32 counts into 0..255: mod 256 (uint8 overflow, bit-exactly) or
    min(count, 255)."""
    return torch.remainder(planes, 256) if wrap_uint8 else planes.clamp(max=255)


def raster_from_planes(planes: torch.Tensor, wrap_uint8: bool = True) -> torch.Tensor:
    """(B, H, 2W) int32 planes [pos | neg] -> (B, H, W, 3) uint8 [pos, 0, neg],
    each count wrapped by :func:`wrap_counts`."""
    W = planes.shape[-1] // 2
    planes = wrap_counts(planes, wrap_uint8)
    pos, neg = planes[..., :W].to(torch.uint8), planes[..., W:].to(torch.uint8)
    return torch.stack([pos, torch.zeros_like(pos), neg], dim=-1)


def voxelize_raster_reference(col: torch.Tensor, ys: torch.Tensor, H: int, W: int,
                              wrap_uint8: bool = True) -> torch.Tensor:
    """Plain version of the raster mode: K1's plain planes, wrapped and
    stacked (voxelize_fused's tail without a time surface). Returns (B, H, W,
    3) uint8."""
    return raster_from_planes(hist_planes_cols_reference(col, ys, H, W), wrap_uint8)


def _check_cuda_events(name: str, col: torch.Tensor, ys: torch.Tensor) -> None:
    """The device, dtype, shape and layout rules both CUDA wrappers share."""
    if col.device.type != "cuda" or ys.device != col.device:
        raise ValueError(f"{name}: col on {col.device}, ys on {ys.device}")
    if col.dtype != torch.int32 or ys.dtype != torch.int32:
        raise TypeError(f"{name} takes int32, got {col.dtype}/{ys.dtype}")
    if col.dim() != 2 or col.shape != ys.shape:
        raise ValueError(f"{name}: shapes {tuple(col.shape)} vs {tuple(ys.shape)}")
    if not (col.is_contiguous() and ys.is_contiguous()):
        raise ValueError(f"{name}: col and ys must be contiguous")


def _launch(name: str, entry: str, col, ys, H: int, W: int, raster: bool, wrap_uint8: bool,
            skip: bool) -> torch.Tensor:
    """One launch of the histogram body through C entry ``entry``: the
    output is allocated, never filled; the kernel writes every cell."""
    _check_cuda_events(name, col, ys)
    from mem_tpu_torch.kernels import build

    # 16-byte event loads: a view that starts off a 16-byte boundary is copied
    if (col.data_ptr() | ys.data_ptr()) % 16:
        col, ys = col.clone(), ys.clone()
    B, N = col.shape
    dev = col.device
    plan = hist_plan(B, N, H, W, sm_count(dev.index), skip)
    lib = build.library(dev)
    out = (torch.empty((B, H, W, 3), dtype=torch.uint8, device=dev) if raster else
           torch.empty((B, H, 2 * W), dtype=torch.int32, device=dev))
    args = [col.data_ptr(), ys.data_ptr(), out.data_ptr()]
    if entry == "mem_hist_planes_cols_sorted":
        bounds = None
        if plan.skip:
            bounds = torch.empty(B, max(-(-N // CHUNK), 1), 2, dtype=torch.int32, device=dev)
        args.append(None if bounds is None else bounds.data_ptr())
    rc = getattr(lib, entry)(*args, B, N, H, W, MODES[wrap_uint8 if raster else None],
                             plan.counter_bytes, plan.rows, plan.blocks,
                             torch.cuda.current_stream(dev).cuda_stream)
    build.check(name, rc)
    count_launch(name)
    return out


def hist_planes_cols(col: torch.Tensor, ys: torch.Tensor, H: int, W: int, raster: bool = False,
                     wrap_uint8: bool = True) -> torch.Tensor:
    """(B, N) int32 col/ys -> (B, H, 2W) int32 count planes [pos | neg], or
    with ``raster`` the (B, H, W, 3) uint8 raster (``wrap_uint8``: mod 256,
    else min(count, 255)).

    CPU tensors take the plain version; CUDA tensors launch K1 (one launch
    for the whole batch, planned by :func:`hist_plan`) or raise."""
    if col.device.type == "cpu":
        if raster:
            return voxelize_raster_reference(col, ys, H, W, wrap_uint8)
        return hist_planes_cols_reference(col, ys, H, W)
    return _launch("hist_planes_cols", "mem_hist_planes_cols", col, ys, H, W, raster,
                   wrap_uint8, False)


def sort_events_by_row(col: torch.Tensor, ys: torch.Tensor, H: int):
    """The packed-key sort of the reference (voxelize_pallas.py:166-169):
    key = ys * 4096 + col with every ys >= H folded onto the sentinel H, one
    sort per sample, rows ascending and the invalid events last."""
    key = torch.where(ys >= H, torch.full_like(ys, H), ys) * KEY_COLS + col
    key = torch.sort(key, dim=1).values
    return key % KEY_COLS, key // KEY_COLS


def hist_planes_cols_sorted_reference(col: torch.Tensor, ys: torch.Tensor, H: int, W: int,
                                      presorted: bool = False) -> torch.Tensor:
    """Plain version of K4: the scatter-add of K1's plain version after the
    same sort. Returns (B, H, 2W) int32."""
    assert 2 * W < KEY_COLS, "packed key reserves 12 bits for the column"
    if not presorted:
        col, ys = sort_events_by_row(col, ys, H)
    return hist_planes_cols_reference(col, ys, H, W)


def hist_planes_cols_sorted(col: torch.Tensor, ys: torch.Tensor, H: int, W: int,
                            presorted: bool = False, raster: bool = False,
                            wrap_uint8: bool = True) -> torch.Tensor:
    """(B, N) int32 col/ys -> (B, H, 2W) int32 count planes [pos | neg] by
    row bands (K4), or the uint8 raster as :func:`hist_planes_cols` gives it.
    ``presorted`` promises y-sorted rows (the invalid events then sit at the
    END with ys >= H, voxelize_pallas.py:159-161): each band then reads only
    the chunks that meet it. A broken promise costs time, never counts: the
    skip is conservative. Unsorted events are counted as they come, with no
    sort (K1's pass, launched here).

    CPU tensors take the plain version; CUDA tensors launch K4 (one launch
    for the whole batch) or raise."""
    assert 2 * W < KEY_COLS, "packed key reserves 12 bits for the column"
    if col.device.type == "cpu":
        planes = hist_planes_cols_sorted_reference(col, ys, H, W, presorted)
        return raster_from_planes(planes, wrap_uint8) if raster else planes
    return _launch("hist_planes_cols_sorted", "mem_hist_planes_cols_sorted", col, ys, H, W,
                   raster, wrap_uint8, presorted)


def voxelize_planes(xs, ys, wpos, wneg, H: int, W: int, y_sorted: bool = False,
                    raster: bool = False, wrap_uint8: bool = True) -> torch.Tensor:
    """(B, N) clamped coordinates + {0, 1} polarity weights -> (B, H, 2W)
    int32 count planes [pos | neg] (the role of voxelize_pallas_planes), or
    with ``raster`` the (B, H, W, 3) uint8 raster of them.
    The one home of the K1-vs-K4 routing rule. ``y_sorted`` promises that
    each sample's valid events arrive sorted by y (the seg pipeline's host
    presort), which lets K4 skip the chunks a band does not meet."""
    col, ysf = pack_cols(xs, ys, wpos, wneg, H, W)
    col, ysf = col.contiguous(), ysf.contiguous()
    kw = {"raster": True, "wrap_uint8": wrap_uint8} if raster else {}
    if H * 2 * W >= WIDE_CANVAS_CELLS and 2 * W < KEY_COLS:
        return hist_planes_cols_sorted(col, ysf, H, W, presorted=y_sorted, **kw)
    return hist_planes_cols(col, ysf, H, W, **kw)
