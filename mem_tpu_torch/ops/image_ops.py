"""Post-rasterization image transforms, batched NHWC.

Port of mem_tpu/ops/image_ops.py: the antialiased bilinear resize with
per-sample source extents, the random crop, the random resized crop, the
event-image channel ops of the reference's mem/transforms.py, the
pretraining ColorJitter and timm's RandomErasing (the IMNET image path).
Channel convention: 0 = positive counts, 1 = time surface, 2 = negative
counts; a C != 3 image is a voxel grid whose channels are all counts.

The random windows and boxes are host draws (numpy, the reference's
distributions; the reference draws them from ``jax.random`` keys on the
device): ``draw_rrc_window`` / ``rrc_window`` and ``draw_random_erasing`` /
``erasing_boxes``. The window and box arithmetic is the reference's, in f32.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from mem_tpu_torch.ops.consts import as_f32, constant


def _triangle_resize_matrix(out_size: int, src_size: int, src_extent,
                            src_offset=0.0, device=None) -> torch.Tensor:
    """(..., out_size, src_size) f32 triangle-filter resampling matrices
    (image_ops.py:27-53). ``src_extent`` (and ``src_offset``) may be
    (B,) tensors of per-sample logical source lengths inside the static
    canvas. The filter stretches by max(scale, 1) so downscaling low-passes
    (torch/PIL antialias=True); taps outside the logical window are zeroed
    and rows normalized to sum 1 (1e-12 floor)."""
    ext = as_f32(src_extent, device)[..., None, None]
    off = as_f32(src_offset, device)[..., None, None]
    scale = ext / out_size
    fscale = torch.clamp(scale, min=1.0)
    out_c = off + (torch.arange(out_size, dtype=torch.float32, device=device)[:, None]
                   + 0.5) * scale
    src_c = torch.arange(src_size, dtype=torch.float32, device=device)[None, :] + 0.5
    w = torch.clamp(1.0 - torch.abs(out_c - src_c) / fscale, min=0.0)
    inside = (src_c >= off) & (src_c < off + ext)
    w = w * inside
    return w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-12)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int,
                    src_h=None, src_w=None) -> torch.Tensor:
    """Antialiased bilinear resize of (..., H, W, C) to (..., out_h, out_w, C)
    in f32 as two products ``Wy @ img @ Wx^T`` with one matrix pair for all
    leading axes (image_ops.py:56-80); plain align_corners=False bilinear
    when upscaling. src_h/src_w are optional logical source extents within
    the canvas (default the full canvas). The segmentation model uses it for
    440x640 -> 512^2, the heads' upsamples and the logits back to 440x640.
    Full f32 products: on CUDA this needs
    torch.backends.cuda.matmul.allow_tf32 False (PyTorch's default)."""
    H, W = img.shape[-3], img.shape[-2]
    dev = img.device
    wy = _triangle_resize_matrix(out_h, H, H if src_h is None else src_h, device=dev)
    wx = _triangle_resize_matrix(out_w, W, W if src_w is None else src_w, device=dev)
    out = torch.einsum("oh,...hwc->...owc", wy, img.to(torch.float32))
    return torch.einsum("pw,...owc->...opc", wx, out)


def resize_bilinear_batch(imgs: torch.Tensor, out_h: int, out_w: int,
                          src_hs=None, src_ws=None) -> torch.Tensor:
    """(B, H, W, C) -> (B, out_h, out_w, C) f32 with per-sample (B,) source
    extents. Full f32 products: on CUDA this needs
    torch.backends.cuda.matmul.allow_tf32 False (PyTorch's default)."""
    B, H, W, C = imgs.shape
    dev = imgs.device
    src_hs = torch.full((B,), H, device=dev) if src_hs is None else src_hs.to(dev)
    src_ws = torch.full((B,), W, device=dev) if src_ws is None else src_ws.to(dev)
    wy = _triangle_resize_matrix(out_h, H, src_hs, device=dev)     # (B, oh, H)
    wx = _triangle_resize_matrix(out_w, W, src_ws, device=dev)     # (B, ow, W)
    x = imgs.to(torch.float32).reshape(B, H, W * C)
    x = torch.bmm(wy, x).reshape(B, out_h, W, C)                   # (B, oh, W, C)
    x = x.permute(0, 1, 3, 2).reshape(B, out_h * C, W)
    x = torch.matmul(x, wx.transpose(1, 2))                        # (B, oh*C, ow)
    return x.reshape(B, out_h, C, out_w).permute(0, 1, 3, 2).contiguous()


def rrc_window(H: int, W: int, area_frac, log_ratio, u: float, v: float,
               ratio=(3.0 / 4.0, 4.0 / 3.0)):
    """The random-resized-crop window (top, left, crop_h, crop_w), f32 source
    pixels, of ``random_resized_crop`` (image_ops.py:95-143) from its draws:
    10 attempts of area fraction ``area_frac`` (10,) and log aspect
    ``log_ratio`` (10,); the first whose window fits wins and sits at
    (u * (H - crop_h), v * (W - crop_w)); with none, torchvision's centred
    fallback at the clamped aspect."""
    area = np.float32(H * W) * np.asarray(area_frac, np.float32)
    ar = np.exp(np.asarray(log_ratio, np.float32))
    ws, hs = np.sqrt(area * ar), np.sqrt(area / ar)
    ok = (ws <= W) & (hs <= H)
    in_ratio = W / H
    if ok.any():
        first = int(np.argmax(ok))
        crop_w, crop_h = ws[first], hs[first]
        top = np.float32(u) * (np.float32(H) - crop_h)
        left = np.float32(v) * (np.float32(W) - crop_w)
    else:
        crop_w = W if in_ratio <= ratio[1] else H * ratio[1]
        crop_h = W / ratio[0] if in_ratio < ratio[0] else H
        crop_w, crop_h = np.float32(crop_w), np.float32(crop_h)
        top, left = (np.float32(H) - crop_h) / 2, (np.float32(W) - crop_w) / 2
    return tuple(float(np.float32(x)) for x in (top, left, crop_h, crop_w))


def draw_rrc_window(rng: np.random.Generator, H: int, W: int, scale=(0.08, 1.0),
                    ratio=(3.0 / 4.0, 4.0 / 3.0)):
    """Host draws of one random-resized-crop window (:func:`rrc_window`):
    area fractions U[scale) and log aspects U[log ratio) for 10 attempts,
    then the two position uniforms."""
    area_frac = rng.uniform(scale[0], scale[1], 10)
    log_ratio = rng.uniform(math.log(ratio[0]), math.log(ratio[1]), 10)
    u, v = rng.random(2)
    return rrc_window(H, W, area_frac, log_ratio, u, v, ratio)


def random_resized_crop(img: torch.Tensor, window, out_h: int, out_w: int) -> torch.Tensor:
    """torchvision RandomResizedCrop of one (H, W, C) image at a host-drawn
    ``window`` (top, left, crop_h, crop_w) (:func:`draw_rrc_window`): the
    crop and the antialiased resample are the two f32 products of the
    window's triangle matrices (image_ops.py:95-143). Full f32 products: on
    CUDA this needs torch.backends.cuda.matmul.allow_tf32 False (PyTorch's
    default)."""
    H, W, _ = img.shape
    top, left, crop_h, crop_w = window
    wy = _triangle_resize_matrix(out_h, H, crop_h, top, device=img.device)
    wx = _triangle_resize_matrix(out_w, W, crop_w, left, device=img.device)
    out = torch.einsum("oh,hwc->owc", wy, img.to(torch.float32))
    return torch.einsum("pw,owc->opc", wx, out)


def _count_ch(img: torch.Tensor) -> torch.Tensor:
    """Count-channel mask: [1, 0, 1] for the 3-channel histogram, all ones
    for a voxel grid."""
    c = img.shape[-1]
    if c == 3:
        return constant((1.0, 0.0, 1.0), img.dtype, img.device)
    return torch.ones(c, dtype=img.dtype, device=img.device)


def remove_timesurface(img: torch.Tensor) -> torch.Tensor:
    """Zero channel 1 (RemoveTimesurface); no-op for voxel grids."""
    if img.shape[-1] != 3:
        return img
    return img * _count_ch(img)


def log_transform(img: torch.Tensor) -> torch.Tensor:
    """log1p on the count channels (LogTransform)."""
    ch = _count_ch(img)
    return torch.log1p(img) * ch + img * (1 - ch)


def gamma_transform(img: torch.Tensor, gamma: float) -> torch.Tensor:
    """pow-gamma on the count channels (GammaTransform)."""
    ch = _count_ch(img)
    return torch.pow(torch.clamp(img, min=0.0), gamma) * ch + img * (1 - ch)


def normalize_event(img: torch.Tensor) -> torch.Tensor:
    """Scale the count channels by 1 / their joint per-sample max, if
    nonzero (NormalizeEvent). Multiplies by the reciprocal, as the
    reference does (image_ops.py:206-207), rather than dividing."""
    ch = _count_ch(img)
    m = (img * ch).amax(dim=(-3, -2, -1), keepdim=True)
    factor = torch.where(m > 0, 1.0 / torch.clamp(m, min=1e-30), torch.ones_like(m))
    return img * (ch * factor + (1 - ch))


def remove_hot_pixels(img: torch.Tensor, num_stds: float = 10.0,
                      num_hot_pixels: int | None = None) -> torch.Tensor:
    """Zero the count channels at hot pixels (RemoveHotPixels,
    image_ops.py:210-248), per sample over (H, W, C).

    Default: a pixel is hot where any count plane exceeds (strictly)
    mean + num_stds * std, mean/std joint over the count planes with
    Bessel's correction. ``num_hot_pixels``: the k largest count values are
    hot (threshold at the k-th order statistic)."""
    c = img.shape[-1]
    # the count planes 0 and 2, by a kept index tensor (ops/consts.py)
    cnt = img.index_select(-1, constant((0, 2), torch.long, img.device)) if c == 3 else img
    if num_hot_pixels is not None:
        flat = cnt.reshape(*cnt.shape[:-3], -1)
        k = min(int(num_hot_pixels), flat.shape[-1])
        kth = torch.topk(flat, k, dim=-1).values[..., -1]
        thr = kth[..., None, None, None] - 1e-30
        hot = (cnt >= thr).any(dim=-1)
    else:
        n = cnt.shape[-3] * cnt.shape[-2] * cnt.shape[-1]
        mean = cnt.mean(dim=(-3, -2, -1), keepdim=True)
        var = ((cnt - mean) ** 2).sum(dim=(-3, -2, -1), keepdim=True) / (n - 1)
        thr = mean + num_stds * torch.sqrt(var)
        hot = (cnt > thr).any(dim=-1)
    keep = (~hot)[..., None].to(img.dtype)
    chm = _count_ch(img)
    return img * (keep * chm + (1 - chm))


def random_crop_batch(imgs: torch.Tensor, tops, lefts, out_h: int, out_w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, out_h, out_w, C) crops at per-sample (tops,
    lefts) (image_ops.py:146-160). Offsets are clamped into the image, as
    ``lax.dynamic_slice`` clamps them."""
    B, H, W, _ = imgs.shape
    dev = imgs.device
    tops = torch.as_tensor(tops, device=dev).long().clamp(0, H - out_h)
    lefts = torch.as_tensor(lefts, device=dev).long().clamp(0, W - out_w)
    rows = tops[:, None] + torch.arange(out_h, device=dev)[None, :]
    cols = lefts[:, None] + torch.arange(out_w, device=dev)[None, :]
    return imgs[torch.arange(B, device=dev)[:, None, None], rows[:, :, None], cols[:, None, :]]


_CJ_LUMA = (0.2989, 0.587, 0.114)   # ColorJitter's grayscale weights (image_ops.py:256)


def _per_sample(f, img):
    return torch.as_tensor(f, dtype=img.dtype, device=img.device).reshape(
        (-1,) + (1,) * (img.ndim - 1))


def adjust_brightness(img: torch.Tensor, factor) -> torch.Tensor:
    """clip(img * factor, 0, 1), one factor per sample (image_ops.py:259)."""
    return torch.clamp(img * _per_sample(factor, img), 0.0, 1.0)


def adjust_saturation(img: torch.Tensor, factor) -> torch.Tensor:
    """Blend with the luma grayscale, clip to [0, 1] (image_ops.py:263)."""
    f = _per_sample(factor, img)
    luma = constant(_CJ_LUMA, img.dtype, img.device)
    gray = (img * luma).sum(dim=-1, keepdim=True)
    return torch.clamp(f * img + (1.0 - f) * gray, 0.0, 1.0)


def color_jitter_batch(imgs: torch.Tensor, brightness, saturation, order) -> torch.Tensor:
    """torchvision ColorJitter(brightness=s, contrast=0, saturation=s) with
    the per-sample factors and order drawn on the host
    (data/device_pipeline.draw_train_aug): order True = brightness first
    (image_ops.py:268-285)."""
    b_then_s = adjust_saturation(adjust_brightness(imgs, brightness), saturation)
    s_then_b = adjust_brightness(adjust_saturation(imgs, saturation), brightness)
    first = torch.as_tensor(order, device=imgs.device).bool().reshape(-1, 1, 1, 1)
    return torch.where(first, b_then_s, s_then_b)


# ---------------------------------------------------------------------------
# RandomErasing (timm random_erasing.py semantics; the IMNET train path,
# --reprob / --remode / --recount)
# ---------------------------------------------------------------------------

_LOG_RATIO = (math.log(0.3), math.log(3.3))


def erasing_boxes(H: int, W: int, area_frac, log_ratio, u_top, u_left, count: int = 1):
    """(..., 4) int32 boxes (top, left, h, w) of timm's RandomErasing from
    their uniforms, in f32 as the reference's clamped box (``_erase_one``,
    image_ops.py:294-331): area = area_frac * H * W / count, ratio =
    exp(log_ratio), h = clip(round(sqrt(area * ratio)), 1, H - 1), w the same
    with area / ratio, top = floor(u_top * (H - h + 1)), left likewise."""
    f32 = np.float32
    area = np.asarray(area_frac, f32) * f32(H * W) / f32(count)
    ratio = np.exp(np.asarray(log_ratio, f32))
    h = np.clip(np.round(np.sqrt(area * ratio)), 1, H - 1).astype(np.int32)
    w = np.clip(np.round(np.sqrt(area / ratio)), 1, W - 1).astype(np.int32)
    top = np.floor(np.asarray(u_top, f32) * (H - h + 1).astype(f32))
    left = np.floor(np.asarray(u_left, f32) * (W - w + 1).astype(f32))
    return np.stack([top.astype(np.int32), left.astype(np.int32), h, w], axis=-1)


def draw_random_erasing(rngs, H: int, W: int, prob: float, count: int = 1) -> dict:
    """Host draws of ``random_erasing_batch`` for a batch, one generator a
    sample: the gate u < prob (``er_use``, (B,) bool), then per box an area
    fraction U[0.02, 1/3), a log aspect U[log 0.3, log 3.3) and the top and
    left uniforms, made into ``er_box`` (B, count, 4) int32 by
    :func:`erasing_boxes`."""
    B = len(rngs)
    use = np.zeros((B,), bool)
    u = np.zeros((B, count, 4), np.float64)
    for b, rng in enumerate(rngs):
        use[b] = rng.random() < prob
        for k in range(count):
            u[b, k] = (rng.uniform(0.02, 1.0 / 3), rng.uniform(*_LOG_RATIO),
                       rng.random(), rng.random())
    boxes = erasing_boxes(H, W, u[..., 0], u[..., 1], u[..., 2], u[..., 3], count)
    return {"er_use": use, "er_box": boxes}


def fill_noise(shape, generator, device, dtype) -> torch.Tensor:
    """The erasing fill: N(0, 1) of ``shape`` from ``generator`` on ``device``."""
    return torch.randn(shape, generator=generator, device=device, dtype=dtype)


def random_erasing_batch(imgs: torch.Tensor, draws, mode: str = "pixel",
                         fill_generator: torch.Generator | None = None) -> torch.Tensor:
    """timm RandomErasing over (B, H, W, C) at the host draws ``draws``
    (``er_use`` (B,) and ``er_box`` (B, count, 4) tensors on the batch's
    device, :func:`draw_random_erasing`): each box of each sample whose gate
    is on is filled with per-pixel N(0, 1) (``pixel``), per-channel N(0, 1)
    (``rand``) or zeros (``const``). The noise is drawn on the batch's device
    from ``fill_generator``, one full-image draw a box as the reference
    (image_ops.py:318-326), never on the host."""
    if mode not in ("pixel", "rand", "const"):
        raise ValueError(f"remode must be pixel|rand|const, got {mode!r}")
    B, H, W, C = imgs.shape
    dev = imgs.device
    use = draws["er_use"].to(dev).bool().reshape(B, 1, 1, 1)
    boxes = draws["er_box"].to(dev).long()
    ys = torch.arange(H, device=dev).reshape(1, H, 1, 1)
    xs = torch.arange(W, device=dev).reshape(1, 1, W, 1)
    for k in range(boxes.shape[1]):
        top, left, h, w = (boxes[:, k, i].reshape(B, 1, 1, 1) for i in range(4))
        in_box = (ys >= top) & (ys < top + h) & (xs >= left) & (xs < left + w)
        if mode == "pixel":
            fill = fill_noise(imgs.shape, fill_generator, dev, imgs.dtype)
        elif mode == "rand":
            fill = fill_noise((B, 1, 1, C), fill_generator, dev, imgs.dtype).expand_as(imgs)
        else:
            fill = torch.zeros_like(imgs)
        imgs = torch.where(in_box & use, fill, imgs)
    return imgs
