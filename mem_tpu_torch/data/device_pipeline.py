"""On-device preprocessing front end: padded events -> model-ready images.

Port of mem_tpu/data/device_pipeline.py for the eval path: the reference's
transform chain (build_transformNPY, mem/datasets.py:611-660)

  rasterize (voxelize_fused, kernel K1) -> ToTensor (/255)
  -> Resize(bilinear, antialias) [fixed-res datasets] | top-left window
  -> RemoveTimesurface? -> RemoveHotPixels? -> Log/Gamma? -> NormalizeEvent?

runs as torch ops on the batch's device. The training augmentations
(time/x flips, shifts, random crops, RandAugment, ColorJitter) come with the
training slice; ``is_train=True`` raises rather than skip them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from mem_tpu_torch.ops import image_ops as I
from mem_tpu_torch.ops.voxelize import voxelize_fused


@dataclass(frozen=True)
class PreprocConfig:
    """Field for field the reference's PreprocConfig (device_pipeline.py:35)."""
    input_h: int = 224
    input_w: int = 224
    canvas_h: int = 256          # static raster canvas (>= max sensor extent)
    canvas_w: int = 256
    resize_to_input: bool = True  # caltech/ncars/dsec branch (datasets.py:640-642)
    random_crop: bool = False     # imagenet train branch (datasets.py:644-645)
    timesurface: bool = False
    hotpixfilter: bool = True
    hotpix_num_stds: float = 10.0
    logtrafo: bool = False
    gammatrafo: bool = False
    gamma: float = 0.5
    normalize_events: bool = True
    rand_aug: bool = True
    rand_aug_magnitude: int = 20
    rand_aug_batch_ops: bool = False
    color_jitter: float = 0.0
    wrap_uint8: bool = True
    # on-device ReshapeScaleXandY of the compact int16 wire (not ported yet:
    # events_f32 takes the f32 wire only)
    scale_xy_rational: Optional[tuple] = None
    voxel: int = 0


def events_f32(batch: dict) -> torch.Tensor:
    """(B, N, 4) f32 events from the f32 ``events`` wire. The compact int16
    ``events_xyp`` wire (with its on-device exact rescale) is not ported."""
    if "events" in batch:
        return batch["events"]
    raise NotImplementedError(
        "the compact int16 events_xyp wire is not ported yet; ship the f32 "
        "'events' wire (compact_wire=0)")


def preprocess_batch(batch: dict, cfg: PreprocConfig, is_train: bool) -> torch.Tensor:
    """batch: dict of tensors on one device (events, n_valid, and optional
    sample_h / sample_w extents). Returns (B, input_h, input_w, C) f32 in
    [0, 1]; C = 3, or ``cfg.voxel`` in voxel-grid mode."""
    if is_train:
        raise NotImplementedError(
            "preprocess_batch(is_train=True) needs the training augmentations "
            "(flips, shifts, random crop, RandAugment, ColorJitter), which come "
            "with the training slice of the port")
    sample_h = batch.get("sample_h")
    sample_w = batch.get("sample_w")
    img = voxelize_fused(
        events_f32(batch), batch["n_valid"], cfg.canvas_h, cfg.canvas_w,
        sample_W=sample_w, sample_H=sample_h,
        time_surface=cfg.timesurface, wrap_uint8=cfg.wrap_uint8,
        n_bins=cfg.voxel // 2,
    )
    x = img.to(torch.float32) / 255.0                       # ToTensor
    if cfg.resize_to_input:
        x = I.resize_bilinear_batch(x, cfg.input_h, cfg.input_w,
                                    src_hs=sample_h, src_ws=sample_w)
    else:
        x = x[:, : cfg.input_h, : cfg.input_w]

    if not cfg.timesurface:
        x = I.remove_timesurface(x)
    if cfg.hotpixfilter:
        x = I.remove_hot_pixels(x, cfg.hotpix_num_stds)
    if cfg.logtrafo:
        x = I.log_transform(x)
    if cfg.gammatrafo:
        x = I.gamma_transform(x, cfg.gamma)
    if cfg.normalize_events:
        x = I.normalize_event(x)
    return x
