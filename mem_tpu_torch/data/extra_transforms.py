"""Transforms the reference defines and never wires into a pipeline, the
port's own copy of mem_tpu/data/extra_transforms.py (numpy only).

The reference defines three transforms that no shipped config ever composes
into a pipeline (SURVEY.md section 2.3 "dead/unwired"):

- ``EventPhotoMetricDistortion`` (reference mem/datasets.py:190-295) — an
  mmcv-style HSV photometric jitter defined next to the npy pipeline factories
  but never added to any ``transforms.Compose``.
- ``EventJitter`` (reference mem/transforms.py:277-289) — multiplicative
  noise helper, never instantiated.
- ``FixedResizeTransform`` (reference mem/transforms.py:189-196) — fixed-factor
  downscale, never instantiated.

No pipeline of the port composes them either (``--resize`` stays accepted
and inert). They exist so a user who wires them finds the reference's
behaviour. Like every host-side preprocessing op they take an explicit
``np.random.Generator`` instead of the reference's global ``np.random``
state, so parity with the reference is behavioural, not bit-stream; with the
JAX package's copy it is exact.

Reference quirks preserved deliberately:

1. ``EventPhotoMetricDistortion.__call__`` receives (C, H, W), moves to
   (H, W, C) and NEVER moves back — callers get HWC out of a CHW pipeline
   (mem/datasets.py:270, 285).
2. Its docstring promises "random contrast ... second or second to last",
   but the code only applies contrast when ``mode == 1`` (second); the
   mode == 0 "second to last" branch is absent, so half the time contrast is
   silently skipped entirely (mem/datasets.py:276-280 — there is no second
   ``self.contrast`` call).
3. ``EventJitter`` calls ``F.dropout(..., training=False)`` — a no-op — so
   the advertised ``dropout`` knob has no effect; the jitter is always dense
   (mem/transforms.py:287).
4. ``FixedResizeTransform`` truncates ``int(size / factor)`` (floor, not
   round) per side (mem/transforms.py:196).

The HSV conversions mirror OpenCV's 8-bit semantics (H in [0, 180), S and V
in [0, 255]) because the reference routes through ``mmcv.bgr2hsv`` which is a
``cv2.cvtColor`` wrapper.
"""
from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# OpenCV-style uint8 BGR <-> HSV
# ---------------------------------------------------------------------------

def bgr2hsv_u8(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 BGR -> uint8 HSV with OpenCV 8-bit ranges.

    H in [0, 180), S/V in [0, 255] — cv2.COLOR_BGR2HSV semantics (the scale
    mmcv.bgr2hsv produces, which the reference's hue arithmetic ``% 180``
    assumes, mem/datasets.py:258).
    """
    b = img[..., 0].astype(np.float64)
    g = img[..., 1].astype(np.float64)
    r = img[..., 2].astype(np.float64)
    v = np.maximum(np.maximum(b, g), r)
    mn = np.minimum(np.minimum(b, g), r)
    diff = v - mn
    s = np.where(v > 0, 255.0 * diff / np.maximum(v, 1e-12), 0.0)
    safe = np.maximum(diff, 1e-12)
    h = np.where(
        diff == 0, 0.0,
        np.where(v == r, 60.0 * (g - b) / safe,
                 np.where(v == g, 120.0 + 60.0 * (b - r) / safe,
                          240.0 + 60.0 * (r - g) / safe)))
    h = np.where(h < 0, h + 360.0, h) / 2.0  # cv2 8-bit: H = degrees / 2
    out = np.stack([np.round(h), np.round(s), v], axis=-1)
    return np.clip(out, 0, 255).astype(np.uint8)


def hsv2bgr_u8(img: np.ndarray) -> np.ndarray:
    """Inverse of :func:`bgr2hsv_u8` (cv2.COLOR_HSV2BGR, 8-bit)."""
    h = img[..., 0].astype(np.float64) * 2.0  # back to degrees
    s = img[..., 1].astype(np.float64) / 255.0
    v = img[..., 2].astype(np.float64)
    c = v * s
    hp = h / 60.0
    x = c * (1.0 - np.abs(hp % 2.0 - 1.0))
    m = v - c
    sector = np.floor(hp).astype(np.int64) % 6
    r = np.choose(sector, [c, x, np.zeros_like(c), np.zeros_like(c), x, c])
    g = np.choose(sector, [x, c, c, x, np.zeros_like(c), np.zeros_like(c)])
    b = np.choose(sector, [np.zeros_like(c), np.zeros_like(c), x, c, c, x])
    out = np.stack([b + m, g + m, r + m], axis=-1)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# EventPhotoMetricDistortion (reference mem/datasets.py:190-295)
# ---------------------------------------------------------------------------

def _convert(img: np.ndarray, alpha: float = 1.0, beta: float = 0.0) -> np.ndarray:
    """``img * alpha + beta`` clipped to [0, 255], uint8 out (datasets.py:217-221)."""
    out = img.astype(np.float32) * alpha + beta
    return np.clip(out, 0, 255).astype(np.uint8)


def photometric_distortion(
    img: np.ndarray,
    rng: np.random.Generator,
    brightness_delta: float = 32,
    contrast_range: tuple = (0.5, 1.5),
    saturation_range: tuple = (0.5, 1.5),
    hue_delta: int = 18,
) -> np.ndarray:
    """Reference ``EventPhotoMetricDistortion.__call__`` on one sample.

    Input (C, H, W); output (H, W, C) uint8 — the reference's axis-move quirk
    (see module docstring, quirk 1). Each sub-op fires with p=0.5, drawn in
    the reference's order: brightness, mode, [contrast if mode==1],
    saturation, hue (datasets.py:269-289). Channels are treated as BGR for
    the HSV trips, exactly as mmcv would treat the event-count planes.

    Documented deviation: the input is quantized to uint8 at entry. The
    (unwired) reference would receive float32 0-255 frames and run cv2's
    FLOAT HSV convention (H in [0,360), S in [0,1]) through integer-style
    ``% 180`` hue arithmetic — numerically incoherent dead code. We pin the
    uint8 convention (mmcv's PhotoMetricDistortion asserts uint8 input for
    exactly this reason) so the op is well-defined if ever wired.
    """
    img = np.moveaxis(np.asarray(img), 0, -1)
    img = np.clip(img, 0, 255).astype(np.uint8)

    if rng.integers(2):  # brightness (datasets.py:224-231)
        img = _convert(img, beta=float(rng.uniform(-brightness_delta,
                                                   brightness_delta)))
    mode = int(rng.integers(2))
    if mode == 1:  # contrast fires ONLY here — quirk 2 (datasets.py:276-280)
        if rng.integers(2):
            img = _convert(img, alpha=float(rng.uniform(*contrast_range)))
    if rng.integers(2):  # saturation (datasets.py:241-249)
        hsv = bgr2hsv_u8(img)
        hsv[..., 1] = _convert(hsv[..., 1],
                               alpha=float(rng.uniform(*saturation_range)))
        img = hsv2bgr_u8(hsv)
    if rng.integers(2):  # hue (datasets.py:252-260)
        hsv = bgr2hsv_u8(img)
        shift = int(rng.integers(-hue_delta, hue_delta))
        hsv[..., 0] = ((hsv[..., 0].astype(np.int64) + shift) % 180).astype(np.uint8)
        img = hsv2bgr_u8(hsv)
    return img


# ---------------------------------------------------------------------------
# EventJitter (reference mem/transforms.py:277-289)
# ---------------------------------------------------------------------------

def event_jitter(
    x: np.ndarray,
    rng: np.random.Generator,
    factor: float = 0.1,
    dropout: float = 0.8,
) -> np.ndarray:
    """``x + x * factor * (U[0,1) - 0.5)`` elementwise.

    ``dropout`` is accepted and ignored: the reference passes
    ``training=False`` to ``F.dropout`` so the mask never applies (quirk 3).
    """
    del dropout  # reference quirk: F.dropout(training=False) is a no-op
    x = np.asarray(x, dtype=np.float32)
    jitter = x * factor * (rng.random(x.shape, dtype=np.float32) - 0.5)
    return x + jitter


# ---------------------------------------------------------------------------
# FixedResizeTransform (reference mem/transforms.py:189-196)
# ---------------------------------------------------------------------------

def _triangle_matrix_np(out_size: int, src_size: int) -> np.ndarray:
    """(out, src) PIL-convention antialiased bilinear resampling matrix.

    torchvision's ``F.resize`` on a PIL input delegates to PIL's BILINEAR
    resampler, which stretches the triangle filter by max(scale, 1) — the
    same convention as ops/image_ops._triangle_resize_matrix, restated here
    in plain numpy because this op runs host-side per sample.
    """
    scale = src_size / out_size
    support = max(scale, 1.0)
    centers = (np.arange(out_size) + 0.5) * scale  # source coords of out px
    src = np.arange(src_size) + 0.5
    w = np.maximum(0.0, 1.0 - np.abs(src[None, :] - centers[:, None]) / support)
    return w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)


def fixed_resize(img: np.ndarray, factor: float) -> np.ndarray:
    """Downscale (H, W, C) or (H, W) by ``factor`` with floor-truncated sides
    (quirk 4) and PIL-style antialiased bilinear resampling."""
    img = np.asarray(img, dtype=np.float32)
    h, w = img.shape[0], img.shape[1]
    out_h, out_w = int(h / factor), int(w / factor)
    my = _triangle_matrix_np(out_h, h)
    mx = _triangle_matrix_np(out_w, w)
    flat = img.reshape(h, -1)
    out = my @ flat  # (out_h, w*C)
    out = out.reshape(out_h, w, -1)
    out = np.einsum("ow,hwc->hoc", mx, out)
    if img.ndim == 2:
        return out[..., 0]
    return out
