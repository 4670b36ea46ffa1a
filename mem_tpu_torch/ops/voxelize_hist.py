"""Event-count histogram planes: kernel K1 and its plain version.

Port of mem_tpu/ops/voxelize_pallas.py. The TPU kernel (``_dense_kernel``)
builds one-hot factors in VMEM and contracts them on the matrix unit; on
Hopper the same function is a scatter histogram with integer atomics
(csrc/voxelize_hist.cu). Inputs are the pre-packed per-event coordinates of
:func:`pack_cols`: col = x + W * (p < 0) in [0, 2W), 2W marks an invalid
event; ys in [0, H), H marks one.

Routing: the reference sends canvases with H * 2W >= WIDE_CANVAS_CELLS
(300,000 cells, e.g. DSEC 440x640 and bin-folded ``--voxel`` canvases) to a
y-sorted row-tiled kernel (K4, ``hist_planes_cols_sorted``). That kernel is
not ported yet: here the dense kernel serves every canvas, and its global
atomics have no per-block plane to outgrow.
"""
from __future__ import annotations

import torch

from mem_tpu_torch.kernels import count_launch


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


def hist_planes_cols(col: torch.Tensor, ys: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, N) int32 col/ys -> (B, H, 2W) int32 count planes [pos | neg].

    CPU tensors take the plain version; CUDA tensors launch K1 (one launch
    for the whole batch) or raise."""
    if col.device.type == "cpu":
        return hist_planes_cols_reference(col, ys, H, W)
    if col.device.type != "cuda" or ys.device != col.device:
        raise ValueError(f"hist_planes_cols: col on {col.device}, ys on {ys.device}")
    if col.dtype != torch.int32 or ys.dtype != torch.int32:
        raise TypeError(f"hist_planes_cols takes int32, got {col.dtype}/{ys.dtype}")
    if col.dim() != 2 or col.shape != ys.shape:
        raise ValueError(f"hist_planes_cols: shapes {tuple(col.shape)} vs {tuple(ys.shape)}")
    if not (col.is_contiguous() and ys.is_contiguous()):
        raise ValueError("hist_planes_cols: col and ys must be contiguous")
    from mem_tpu_torch.kernels import build

    B, N = col.shape
    lib = build.library()
    out = torch.zeros(B, H, 2 * W, dtype=torch.int32, device=col.device)
    stream = torch.cuda.current_stream(col.device).cuda_stream
    rc = lib.mem_hist_planes_cols(col.data_ptr(), ys.data_ptr(), out.data_ptr(),
                                  B, N, H, W, stream)
    build.check("hist_planes_cols", rc)
    count_launch("hist_planes_cols")
    return out


def voxelize_planes(xs, ys, wpos, wneg, H: int, W: int) -> torch.Tensor:
    """(B, N) clamped coordinates + {0, 1} polarity weights -> (B, H, 2W)
    int32 count planes [pos | neg] (the role of voxelize_pallas_planes)."""
    col, ysf = pack_cols(xs, ys, wpos, wneg, H, W)
    return hist_planes_cols(col.contiguous(), ysf.contiguous(), H, W)
