"""Post-rasterization image transforms, batched NHWC.

Port of mem_tpu/ops/image_ops.py: the antialiased bilinear resize with
per-sample source extents, the random crop, the event-image channel ops of
the reference's mem/transforms.py and the pretraining ColorJitter.
Channel convention: 0 = positive counts, 1 = time surface, 2 = negative
counts; a C != 3 image is a voxel grid whose channels are all counts.
Random erasing (the IMNET image path) comes with its slice.
"""
from __future__ import annotations

import torch


def _triangle_resize_matrix(out_size: int, src_size: int, src_extent,
                            src_offset=0.0, device=None) -> torch.Tensor:
    """(..., out_size, src_size) f32 triangle-filter resampling matrices
    (image_ops.py:27-53). ``src_extent`` (and ``src_offset``) may be
    (B,) tensors of per-sample logical source lengths inside the static
    canvas. The filter stretches by max(scale, 1) so downscaling low-passes
    (torch/PIL antialias=True); taps outside the logical window are zeroed
    and rows normalized to sum 1 (1e-12 floor)."""
    ext = torch.as_tensor(src_extent, dtype=torch.float32, device=device)[..., None, None]
    off = torch.as_tensor(src_offset, dtype=torch.float32, device=device)[..., None, None]
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


def _count_ch(img: torch.Tensor) -> torch.Tensor:
    """Count-channel mask: [1, 0, 1] for the 3-channel histogram, all ones
    for a voxel grid."""
    c = img.shape[-1]
    if c == 3:
        return torch.tensor([1.0, 0.0, 1.0], dtype=img.dtype, device=img.device)
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
    cnt = img[..., [0, 2]] if c == 3 else img
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
    luma = torch.tensor(_CJ_LUMA, dtype=img.dtype, device=img.device)
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
