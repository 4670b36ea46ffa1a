"""Cross-stage checkpoint surgery (pretrain -> finetune -> segmentation).

The port's own copy of mem_tpu/utils/surgery.py (mem/utils.py:613-732), on
state_dicts in the reference torch schema instead of flax trees:
  - drop ``mask_token`` / ``lm_head`` and whatever the target does not have
    or holds in another shape;
  - expand a shared relative-position-bias table into per-block tables
    (pretraining uses one shared table, the downstream models one per block);
  - geometric-progression interpolation of rel-pos tables across patch-grid
    sizes (the BEiT trick: source coordinates laid out on a geometric grid so
    long-range offsets compress, then bicubic resampling): 14x14 -> 32x32
    from pretraining at 224^2 to segmentation at 512^2;
  - bicubic interpolation of absolute position embeddings.
All of it is numpy (and scipy's spline), as in the reference.
"""
from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np


def _interp_cubic_grid(x, y, z, dx, dy):
    """cubic spline on a rectilinear (possibly non-uniform) grid — the
    replacement for removed scipy.interpolate.interp2d (utils.py:700-704)."""
    from scipy.interpolate import RectBivariateSpline

    spl = RectBivariateSpline(np.asarray(x), np.asarray(y), np.asarray(z), kx=3, ky=3)
    return spl(np.asarray(dx), np.asarray(dy))


def interpolate_rel_pos_bias(table: np.ndarray, src_size: int, dst_size: int,
                             num_extra_tokens: int = 3) -> np.ndarray:
    """(src_num_pos, heads) -> (dst_num_pos, heads) with the geometric
    progression resampling of utils.py:655-707."""
    table = np.asarray(table, dtype=np.float64)
    num_heads = table.shape[1]
    extra = table[-num_extra_tokens:]
    body = table[:-num_extra_tokens]

    def geometric_progression(a, r, n):
        return a * (1.0 - r**n) / (1.0 - r)

    left, right = 1.01, 1.5
    while right - left > 1e-6:
        q = (left + right) / 2.0
        gp = geometric_progression(1, q, src_size // 2)
        if gp > dst_size // 2:
            right = q
        else:
            left = q

    dis = []
    cur = 1.0
    for i in range(src_size // 2):
        dis.append(cur)
        cur += q ** (i + 1)
    r_ids = [-v for v in reversed(dis)]
    x = r_ids + [0] + dis
    y = r_ids + [0] + dis
    t = dst_size // 2.0
    dx = np.arange(-t, t + 0.1, 1.0)
    dy = np.arange(-t, t + 0.1, 1.0)

    out = []
    for h in range(num_heads):
        z = body[:, h].reshape(src_size, src_size)
        out.append(_interp_cubic_grid(x, y, z, dx, dy).reshape(-1, 1))
    new_body = np.concatenate(out, axis=-1)
    return np.concatenate([new_body, extra], axis=0).astype(np.float32)


def _cubic_kernel(t: np.ndarray, A: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel with a=-0.75 (the torch/PIL constant)."""
    at = np.abs(t)
    near = ((A + 2.0) * at - (A + 3.0)) * at * at + 1.0
    far = (((at - 5.0) * at + 8.0) * at - 4.0) * A
    return np.where(at <= 1.0, near, np.where(at < 2.0, far, 0.0))


def _resize_bicubic_axis(arr: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """Separable bicubic resampling along one axis, matching
    ``torch.nn.functional.interpolate(mode='bicubic', align_corners=False)``:
    half-pixel coordinate mapping, 4-tap Keys kernel (a=-0.75), edge clamp."""
    n = arr.shape[axis]
    if n == out_size:
        return arr
    scale = n / out_size
    x = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    x0 = np.floor(x).astype(np.int64)
    frac = x - x0
    shape = [1] * arr.ndim
    shape[axis] = out_size
    out = np.zeros_like(np.take(arr, np.zeros(out_size, np.int64), axis=axis),
                        dtype=np.float64)
    for k in range(4):
        idx = np.clip(x0 - 1 + k, 0, n - 1)
        w = _cubic_kernel(frac - (k - 1)).reshape(shape)
        out += np.take(arr, idx, axis=axis).astype(np.float64) * w
    return out


def interpolate_abs_pos_embed(pos: np.ndarray, new_grid) -> np.ndarray:
    """(1, 1+N, D) -> (1, 1+gh*gw, D) bicubic (utils.py:710-731).

    ``new_grid`` is an int (square target, the reference's only case) or an
    (gh, gw) tuple (non-square inputs, beyond-reference). The SOURCE grid is
    always square — every checkpoint this ingests was trained at 224².

    Pure-numpy reimplementation of the reference's
    ``F.interpolate(mode='bicubic', align_corners=False)``."""
    pos = np.asarray(pos)
    gh, gw = (new_grid, new_grid) if np.isscalar(new_grid) else new_grid
    d = pos.shape[-1]
    n = pos.shape[1] - 1
    orig = int(round(n**0.5))
    if (orig, orig) == (gh, gw):
        return pos
    extra = pos[:, :1]
    body = pos[:, 1:].astype(np.float32).reshape(1, orig, orig, d)
    body = _resize_bicubic_axis(body, 1, gh)
    body = _resize_bicubic_axis(body, 2, gw)
    body = body.astype(np.float32).reshape(1, gh * gw, d)
    return np.concatenate([extra, body], axis=1)


def surgery_for_finetune(pretrain_sd: Dict, finetune_template_sd: Dict,
                         dst_window: Tuple[int, int]) -> Dict[str, np.ndarray]:
    """Adapt a pretraining state_dict onto a downstream template state_dict
    (utils.py:613-732); both map reference-schema names to arrays (numpy or
    anything ``np.asarray`` takes), the template's names without a
    ``backbone.`` prefix. Returns the template with every matching entry
    replaced, as numpy arrays.

    Copies every entry the template has in the same shape, drops ``lm_head``
    / ``mask_token`` and mismatched heads, interpolates rel-pos tables to
    ``dst_window`` and abs pos embeds to the template's grid, and expands a
    shared ``rel_pos_bias`` table into every block's own."""
    src = {k: np.asarray(v) for k, v in pretrain_sd.items()}
    dst = {k: np.array(np.asarray(v), copy=True) for k, v in finetune_template_sd.items()}

    # 1. shared -> per-block rel pos expansion
    shared = src.pop("rel_pos_bias.relative_position_bias_table", None)

    def num_pos_for(win):
        return (2 * win[0] - 1) * (2 * win[1] - 1) + 3

    def adapt_table(table):
        dst_num = num_pos_for(dst_window)
        src_num = table.shape[0]
        if src_num == dst_num:
            return table
        src_size = int(round((src_num - 3) ** 0.5))
        dst_size = int(round((dst_num - 3) ** 0.5))
        return interpolate_rel_pos_bias(table, src_size, dst_size)

    for k, v in src.items():
        parts = k.split(".")
        if parts[0] in ("mask_token", "lm_head") or k not in dst:
            continue
        tgt = dst[k]
        if parts[-1] == "relative_position_bias_table":
            v = adapt_table(v)
        elif parts[-1] == "pos_embed" and v.shape != tgt.shape:
            v = interpolate_abs_pos_embed(v, int(round((tgt.shape[1] - 1) ** 0.5)))
        if v.shape != tgt.shape:
            print(f"surgery: dropping {k} {v.shape} vs {tgt.shape}")
            continue
        dst[k] = v.astype(tgt.dtype)

    if shared is not None:
        shared = adapt_table(shared)
        for k in dst:
            if re.fullmatch(r"blocks\.\d+\.attn\.relative_position_bias_table", k):
                dst[k] = shared.copy()
    return dst
