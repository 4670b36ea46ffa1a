"""Event -> histogram-image rasterization ("voxelization"), batched.

Port of mem_tpu/ops/voxelize.py ``voxelize_fused`` (voxelize.py:228-391).
The contract (reference EventArrToImg, mem/datasets.py:552-595): events
(B, N, 4) ``[x, y, t, p]`` -> (B, H, W, 3) uint8 with channel 0 = count of
p == +1 events (wrapping mod 256), channel 1 = optional time surface,
channel 2 = count of p == -1 events; or, with ``n_bins > 0``, the
time-binned voxel grid (B, H, W, 2 * n_bins) [pos bins | neg bins].

The augmentations are index arithmetic ahead of one histogram launch
(kernel K1, or K4 on wide canvases: ops/voxelize_hist.py owns the rule);
the voxel grid rides the same kernels by folding the time bin into the row
index (y' = bin * H + y). Without a time surface and a voxel grid (serving,
pretraining, finetune and seg all take that case) the kernel writes the
uint8 raster itself (its raster mode: XLA fuses the same tail after the
Pallas call in the reference); the time surface and the voxel grid wrap and
stack the int32 planes here.
"""
from __future__ import annotations

import math

import torch

from mem_tpu_torch.ops.voxelize_hist import voxelize_planes, wrap_counts


def _time_surface_planes(xs, ys, ts, valid, in_bounds, H: int, W: int):
    """Last-write-wins normalized timestamp per pixel (_time_surface_plane,
    voxelize.py:184-210): event streams are time-sorted, so the last write
    is the max timestamp -> a scatter-amax over flat pixel indices. The
    normalisation runs over the sample's valid rows; only in-bounds rows
    scatter. Returns (B, H, W) f32 holding integers in [0, 255]."""
    inf = torch.tensor(math.inf, dtype=ts.dtype, device=ts.device)
    t_min = torch.where(valid, ts, inf).amin(dim=1, keepdim=True)
    t_max = torch.where(valid, ts, -inf).amax(dim=1, keepdim=True)
    denom = torch.clamp(t_max - t_min, min=1e-30)
    ts_val = torch.floor((ts - t_min) / denom * 255.0)   # numpy's uint8 truncation
    ts_val = torch.where(in_bounds, ts_val, torch.full_like(ts_val, -1.0))
    flat = (ys * W + xs).long()
    plane = torch.zeros(ts.shape[0], H * W, dtype=ts.dtype, device=ts.device)
    plane = plane.scatter_reduce(1, flat, ts_val, reduce="amax", include_self=True)
    return plane.clamp(min=0.0).view(-1, H, W)


def voxelize_fused(
    events: torch.Tensor,
    n_valid: torch.Tensor,
    H: int,
    W: int,
    *,
    slice_start: torch.Tensor | None = None,
    slice_len: int | None = None,
    time_flip: torch.Tensor | None = None,
    x_flip: torch.Tensor | None = None,
    shift_xy: torch.Tensor | None = None,
    sample_W: torch.Tensor | None = None,
    sample_H: torch.Tensor | None = None,
    time_surface: bool = False,
    wrap_uint8: bool = True,
    y_sorted: bool = False,
    n_bins: int = 0,
) -> torch.Tensor:
    """Batched augmentation + rasterization on the events' device.

    events: (B, N, 4) f32 ``[x, y, t, p]`` zero-padded to N rows; n_valid:
    (B,) int count of real rows. slice_start/slice_len: SliceRandomMaxEvs
    as an index window. time_flip / x_flip: (B,) bool. shift_xy: (B, 2)
    int pixel shifts (out-of-bounds events dropped). sample_W / sample_H:
    (B,) per-sample logical extents (x-flip and shift bounds), default the
    canvas. y_sorted: the caller promises that each sample's valid events
    arrive sorted by y (the seg pipeline's host presort); on a wide canvas
    K4's bands then read only the event chunks they meet. Time and x flips
    keep the y order; a y shift would break it. Safe to leave False, and a
    wrong True costs time, never counts. n_bins > 0: the voxel grid (no time
    surface).

    Returns (B, H, W, 3) uint8, or (B, H, W, 2 * n_bins) when n_bins > 0.
    """
    if n_bins > 0 and time_surface:
        raise ValueError("voxel-grid mode has no time-surface channel")
    B, N, _ = events.shape
    dev = events.device
    if sample_W is None:
        sample_W = torch.full((B,), W, dtype=torch.int32, device=dev)
    if sample_H is None:
        sample_H = torch.full((B,), H, dtype=torch.int32, device=dev)
    sample_W = sample_W.to(torch.int32)[:, None]
    sample_H = sample_H.to(torch.int32)[:, None]

    idx = torch.arange(N, dtype=torch.int32, device=dev)[None, :]
    valid = idx < n_valid.to(torch.int32)[:, None]
    if slice_start is not None and slice_len is not None:
        st = slice_start.to(torch.int32)[:, None]
        valid &= (idx >= st) & (idx < st + slice_len)

    # float -> int32 truncates toward zero, as XLA's convert does
    xs = events[..., 0].to(torch.int32)
    ys = events[..., 1].to(torch.int32)
    ts = events[..., 2]
    ps = events[..., 3]

    if time_flip is not None:
        # t <- t_last - t, p <- -p (counts ignore order; the time surface
        # stays a max over the remapped, still ascending, times)
        t_last = torch.where(valid, ts, torch.full_like(ts, -math.inf)).amax(
            dim=1, keepdim=True)
        tf = time_flip.to(torch.bool)[:, None]
        ts = torch.where(tf, t_last - ts, ts)
        ps = torch.where(tf, -ps, ps)

    if x_flip is not None:
        xs = torch.where(x_flip.to(torch.bool)[:, None], sample_W - 1 - xs, xs)

    if shift_xy is not None:
        shift_xy = shift_xy.to(torch.int32)
        xs = xs + shift_xy[:, 0:1]
        ys = ys + shift_xy[:, 1:2]
        valid &= (xs >= 0) & (xs < sample_W) & (ys >= 0) & (ys < sample_H)

    ok = valid & (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    wpos = (ok & (ps == 1)).to(torch.float32)
    wneg = (ok & (ps == -1)).to(torch.float32)
    xs_c = xs.clamp(0, W - 1)
    ys_c = ys.clamp(0, H - 1)

    if n_bins > 0:
        # time bins over the sample's valid rows, last bin closed, a
        # degenerate range -> bin 0 (voxelize.py:318-355)
        t_min = torch.where(valid, ts, torch.full_like(ts, math.inf)).amin(
            dim=1, keepdim=True)
        t_max = torch.where(valid, ts, torch.full_like(ts, -math.inf)).amax(
            dim=1, keepdim=True)
        t_rng = t_max - t_min
        binf = torch.where(t_rng > 0, (ts - t_min) / t_rng * n_bins,
                           torch.zeros_like(ts))
        bins = binf.to(torch.int32).clamp(0, n_bins - 1)
        # bin folding breaks any host y-presort (voxelize.py:338-342)
        planes = voxelize_planes(xs_c, ys_c + bins * H, wpos, wneg, n_bins * H, W,
                                 y_sorted=False)
        pos = planes[..., :W].reshape(B, n_bins, H, W)
        neg = planes[..., W:].reshape(B, n_bins, H, W)
        grid = wrap_counts(torch.cat([pos, neg], dim=1), wrap_uint8)
        return grid.permute(0, 2, 3, 1).to(torch.uint8)

    if not time_surface:
        return voxelize_planes(xs_c, ys_c, wpos, wneg, H, W, y_sorted=y_sorted, raster=True,
                               wrap_uint8=wrap_uint8)
    planes = wrap_counts(voxelize_planes(xs_c, ys_c, wpos, wneg, H, W, y_sorted=y_sorted),
                         wrap_uint8)
    pos, neg = planes[..., :W], planes[..., W:]
    tss = _time_surface_planes(xs_c, ys_c, ts, valid, ok, H, W)
    return torch.stack([pos.to(torch.uint8), tss.to(torch.uint8),
                        neg.to(torch.uint8)], dim=-1)
