"""Event-count histogram planes: kernels K1 and K4 and their plain versions.

Port of mem_tpu/ops/voxelize_pallas.py. The TPU kernels build one-hot
factors in VMEM and contract them on the matrix unit; on Hopper the same
function is a scatter histogram with integer atomics. Inputs are the
pre-packed per-event coordinates of :func:`pack_cols`: col = x + W * (p < 0)
in [0, 2W), 2W marks an invalid event; ys in [0, H), H marks one.

- K1, ``hist_planes_cols`` (csrc/voxelize_hist.cu): atomics straight into
  the (B, H, 2W) output in device memory; any event order.
- K4, ``hist_planes_cols_sorted`` (csrc/voxelize_hist_sorted.cu): for wide
  canvases. Events sorted by y; one block owns a band of rows in shared
  memory, reads only the event chunks that meet its band and writes the
  band once.

Routing (:func:`voxelize_planes`, its one home, voxelize_pallas.py:204-210):
canvases with H * 2W >= WIDE_CANVAS_CELLS (300,000 cells: DSEC 440x640 and
bin-folded ``--voxel`` canvases) whose column fits the 12 bits of the packed
sort key go to K4, every other canvas to K1.
"""
from __future__ import annotations

import torch

from mem_tpu_torch.kernels import count_launch

WIDE_CANVAS_CELLS = 300_000   # voxelize_pallas.py:57
KEY_COLS = 4096               # the packed sort key keeps 12 bits for the column


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


def hist_planes_cols(col: torch.Tensor, ys: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, N) int32 col/ys -> (B, H, 2W) int32 count planes [pos | neg].

    CPU tensors take the plain version; CUDA tensors launch K1 (one launch
    for the whole batch) or raise."""
    if col.device.type == "cpu":
        return hist_planes_cols_reference(col, ys, H, W)
    _check_cuda_events("hist_planes_cols", col, ys)
    from mem_tpu_torch.kernels import build

    B, N = col.shape
    lib = build.library(col.device)
    out = torch.zeros(B, H, 2 * W, dtype=torch.int32, device=col.device)
    stream = torch.cuda.current_stream(col.device).cuda_stream
    rc = lib.mem_hist_planes_cols(col.data_ptr(), ys.data_ptr(), out.data_ptr(),
                                  B, N, H, W, stream)
    build.check("hist_planes_cols", rc)
    count_launch("hist_planes_cols")
    return out


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
                            presorted: bool = False) -> torch.Tensor:
    """(B, N) int32 col/ys -> (B, H, 2W) int32 count planes [pos | neg] by
    row bands (K4). Sorts by the packed key unless the caller promises
    y-sorted rows (``presorted``: the invalid events then sit at the END with
    ys >= H, voxelize_pallas.py:159-161). A broken promise costs time, never
    counts: the kernel's chunk skip is conservative.

    CPU tensors take the plain version; CUDA tensors launch K4 (one launch
    for the whole batch) or raise."""
    assert 2 * W < KEY_COLS, "packed key reserves 12 bits for the column"
    if col.device.type == "cpu":
        return hist_planes_cols_sorted_reference(col, ys, H, W, presorted)
    _check_cuda_events("hist_planes_cols_sorted", col, ys)
    from mem_tpu_torch.kernels import build

    B, N = col.shape
    lib = build.library(col.device)
    if not presorted:
        col, ys = sort_events_by_row(col, ys, H)
        col, ys = col.contiguous(), ys.contiguous()
    out = torch.empty(B, H, 2 * W, dtype=torch.int32, device=col.device)
    bounds = torch.empty(B, max(lib.mem_hist_sorted_chunks(N), 1), 2, dtype=torch.int32,
                         device=col.device)
    stream = torch.cuda.current_stream(col.device).cuda_stream
    rc = lib.mem_hist_planes_cols_sorted(col.data_ptr(), ys.data_ptr(), out.data_ptr(),
                                         bounds.data_ptr(), B, N, H, W, stream)
    build.check("hist_planes_cols_sorted", rc)
    count_launch("hist_planes_cols_sorted")
    return out


def voxelize_planes(xs, ys, wpos, wneg, H: int, W: int, y_sorted: bool = False) -> torch.Tensor:
    """(B, N) clamped coordinates + {0, 1} polarity weights -> (B, H, 2W)
    int32 count planes [pos | neg] (the role of voxelize_pallas_planes).
    The one home of the K1-vs-K4 routing rule. ``y_sorted`` promises that
    each sample's valid events arrive sorted by y (the seg pipeline's host
    presort), which spares K4 its sort."""
    col, ysf = pack_cols(xs, ys, wpos, wneg, H, W)
    col, ysf = col.contiguous(), ysf.contiguous()
    if H * 2 * W >= WIDE_CANVAS_CELLS and 2 * W < KEY_COLS:
        return hist_planes_cols_sorted(col, ysf, H, W, presorted=y_sorted)
    return hist_planes_cols(col, ysf, H, W)
