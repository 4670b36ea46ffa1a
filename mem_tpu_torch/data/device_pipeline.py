"""On-device preprocessing front end: padded events -> model-ready images.

Port of mem_tpu/data/device_pipeline.py: the reference's transform chain
(build_transformNPY, mem/datasets.py:611-660)

  [scale] -> slice (host) -> time-flip -> x-flip -> shift
  -> rasterize (voxelize_fused, kernel K1) -> ToTensor (/255)
  -> Resize(bilinear, antialias) [fixed-res datasets] | RandomCrop [train,
     pre-scaled datasets] | top-left window
  -> RemoveTimesurface? -> RemoveHotPixels? -> Log/Gamma? -> NormalizeEvent?
  -> ToUint8 -> RandAugment(mag 20) -> ToFloat32       [train]
  -> ColorJitter(brightness, saturation)               [pretraining]

runs as torch ops on the batch's device. The flips and the shift are host
draws the batch already carries (data/pipeline.py). The crop offsets,
RandAugment ops/bins/signs and ColorJitter factors, which the reference
draws from ``jax.random`` keys made from each sample's ``aug_seed``, are
drawn on the host from the same ``aug_seed`` by :func:`draw_train_aug`
(numpy, the same distributions) and ride in the batch, so the CPU and the
card augment a batch identically. ``preprocess_batch(is_train=True)``
raises when they are missing.

The IMNET image path has no events: the host decodes, crops and resizes
(data/image_pipeline.py) and :func:`preprocess_image_cls` runs the train
stack of build_transform_e2v on the device: ToUint8, timm-level
RandAugment at prob 0.5, ToFloat32, RandomErasing, at the host draws of
:func:`draw_image_aug`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from mem_tpu_torch.ops import image_ops as I
from mem_tpu_torch.ops.rand_augment import draw_rand_augment, rand_augment_batch
from mem_tpu_torch.ops.voxelize import voxelize_fused

RAND_AUG_NUM_OPS = 2        # the event path's RandAugment (rand_augment.py:347)
HOST_KEYS = ("ra_batch_ops",)   # draws the host reads back; never moved to a device


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
    # ReshapeScaleXandY of the compact int16 wire's raw coordinates, per
    # axis (num, den, extent) (cli/common._exact_scale_plan)
    scale_xy_rational: Optional[tuple] = None
    voxel: int = 0


def events_f32(batch: dict, scale_xy_rational=None) -> torch.Tensor:
    """(B, N, 4) f32 events from either wire (device_pipeline.py:72-129).

    ``events`` is the f32 (B, N, 4) wire. ``events_xyp`` is the compact
    int16 (B, N, 3) [x, y, p] wire the host ships when the timestamp column
    is dead: t comes back as zeros. With ``scale_xy_rational`` the raw x/y
    are rescaled on the device as round_f32(x * (num / den)): one f64
    multiply and one f32 round, the host path's own arithmetic
    (pipeline.py:147-150). (The reference looks the values up in a table
    because the TPU's f32 divide is not correctly rounded; f64 on the card
    and on the CPU is.)"""
    if "events" in batch:
        return batch["events"]
    e = batch["events_xyp"]
    if scale_xy_rational is not None:
        (nx, dx, _), (ny, dy, _) = scale_xy_rational
        x = (e[..., 0:1].to(torch.float64) * (float(nx) / float(dx))).to(torch.float32)
        y = (e[..., 1:2].to(torch.float64) * (float(ny) / float(dy))).to(torch.float32)
    else:
        x = e[..., 0:1].to(torch.float32)
        y = e[..., 1:2].to(torch.float32)
    return torch.cat([x, y, torch.zeros_like(x), e[..., 2:3].to(torch.float32)], dim=-1)


def draw_train_aug(aug_seed: np.ndarray, cfg: PreprocConfig, H: int, W: int) -> dict:
    """Host draws of the training augmentations for one batch, from each
    sample's ``aug_seed`` (a ``np.random.default_rng(seed)`` per sample):

      crop_tl (B, 2) int32   random-crop (top, left) in [0, H - input_h] x
                             [0, W - input_w] of the (H, W) raster
      ra_ops / ra_bins / ra_signs (B, 2) int32
                             RandAugment op in [0, 14), bin in [0, magnitude],
                             sign in {0, 1} per round (rand_augment.py:359-369)
      ra_batch_ops (2,) int32  with ``rand_aug_batch_ops``: the op of each
                             round, shared by the batch, drawn from
                             (aug_seed[0], 0x5EED) (rand_augment.py:413)
      cj_brightness / cj_saturation (B,) f32
                             ColorJitter factors ~ U[max(0, 1 - s), 1 + s)
      cj_order (B,) bool     brightness first (image_ops.py:273-285)

    The distributions are the reference's; the bits are numpy's."""
    seeds = [int(s) for s in np.asarray(aug_seed).reshape(-1)]
    rngs = [np.random.default_rng(s) for s in seeds]
    B = len(rngs)
    crop = np.zeros((B, 2), np.int32)
    for b, rng in enumerate(rngs):
        crop[b] = (rng.integers(0, max(H - cfg.input_h, 0) + 1),
                   rng.integers(0, max(W - cfg.input_w, 0) + 1))
    batch_rng = (np.random.default_rng((seeds[0], 0x5EED))
                 if cfg.rand_aug_batch_ops else None)
    ops, bins, signs, _, batch_ops = draw_rand_augment(rngs, RAND_AUG_NUM_OPS,
                                                    cfg.rand_aug_magnitude, batch_rng)
    s = float(cfg.color_jitter)
    lo = max(0.0, 1.0 - s)
    cj = np.array([[rng.uniform(lo, 1.0 + s), rng.uniform(lo, 1.0 + s)] for rng in rngs],
                  np.float32).reshape(B, 2)
    order = np.array([rng.random() < 0.5 for rng in rngs], bool)
    out = {"crop_tl": crop, "ra_ops": ops, "ra_bins": bins, "ra_signs": signs,
           "cj_brightness": cj[:, 0], "cj_saturation": cj[:, 1], "cj_order": order}
    if batch_ops is not None:
        out["ra_batch_ops"] = batch_ops
    return out


def with_train_draws(batches, cfg: PreprocConfig):
    """Add the host augmentation draws (:func:`draw_train_aug`) to each
    training batch of an iterator of host batches."""
    for batch in batches:
        batch.update(draw_train_aug(batch["aug_seed"], cfg, cfg.canvas_h, cfg.canvas_w))
        yield batch


def _train_draws(batch: dict, keys, drawer: str = "draw_train_aug(batch['aug_seed'], cfg, H, W)"):
    missing = [k for k in keys if k not in batch]
    if missing:
        raise ValueError(
            f"training preprocessing needs the host augmentation draws {missing}: "
            f"add {drawer} to the batch")
    return [batch[k] for k in keys]


def preprocess_batch(batch: dict, cfg: PreprocConfig, is_train: bool) -> torch.Tensor:
    """batch: dict of tensors on one device (events or events_xyp, n_valid,
    sample_h / sample_w extents; for training the flips, the shift and the
    :func:`draw_train_aug` draws). Returns (B, input_h, input_w, C) f32 in
    [0, 1]; C = 3, or ``cfg.voxel`` in voxel-grid mode."""
    sample_h = batch.get("sample_h")
    sample_w = batch.get("sample_w")
    img = voxelize_fused(
        events_f32(batch, cfg.scale_xy_rational), batch["n_valid"],
        cfg.canvas_h, cfg.canvas_w,
        time_flip=batch.get("time_flip") if is_train else None,
        x_flip=batch.get("x_flip") if is_train else None,
        shift_xy=batch.get("shift_xy") if is_train else None,
        sample_W=sample_w, sample_H=sample_h,
        time_surface=cfg.timesurface, wrap_uint8=cfg.wrap_uint8,
        n_bins=cfg.voxel // 2,
    )
    x = img.to(torch.float32) / 255.0                       # ToTensor
    if cfg.resize_to_input:
        x = I.resize_bilinear_batch(x, cfg.input_h, cfg.input_w,
                                    src_hs=sample_h, src_ws=sample_w)
    elif is_train and cfg.random_crop:
        (crop,) = _train_draws(batch, ("crop_tl",))
        x = I.random_crop_batch(x, crop[:, 0], crop[:, 1], cfg.input_h, cfg.input_w)
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

    if is_train and (cfg.rand_aug or cfg.color_jitter > 0) and cfg.voxel:
        raise ValueError("rand_aug/color_jitter require the 3-channel "
                         "histogram (voxel == 0); pass --rand_aug 0")
    if is_train and cfg.rand_aug:
        ops, bins, signs = _train_draws(batch, ("ra_ops", "ra_bins", "ra_signs"))
        batch_ops = None
        if cfg.rand_aug_batch_ops:
            (batch_ops,) = _train_draws(batch, ("ra_batch_ops",))
        u8 = (255.0 * x).to(torch.uint8)                    # ToUint8 truncation
        u8 = rand_augment_batch(u8, ops, bins, signs, batch_ops)
        x = u8.to(torch.float32) / 255.0                    # ToFloat32
    if is_train and cfg.color_jitter > 0:
        bf, sf, order = _train_draws(batch, ("cj_brightness", "cj_saturation", "cj_order"))
        x = I.color_jitter_batch(x, bf, sf, order)
    return x


def draw_image_aug(aug_seed: np.ndarray, hw, magnitude: int = 9, num_ops: int = 2,
                   mstd: float = 0.5, reprob: float = 0.25, recount: int = 1,
                   batch_ops: bool = False) -> dict:
    """Host draws of :func:`preprocess_image_cls` for one batch of (H, W) =
    ``hw`` images, from each sample's ``aug_seed`` (device_pipeline.py:
    208-239 draws them from jax.random keys folded with 1 and 2):

      ra_ops / ra_bins / ra_signs (B, num_ops) int32, ra_gate (B, num_ops) bool
                             timm-level RandAugment at prob 0.5 from
                             (aug_seed, 1) (ops/rand_augment.draw_rand_augment)
      ra_batch_ops (num_ops,) int32  with ``batch_ops``: each round's op, shared
                             by the batch, from (aug_seed[0], 0x5EED)
      er_use (B,) bool, er_box (B, recount, 4) int32
                             RandomErasing's gate and boxes from (aug_seed, 2)
                             (ops/image_ops.draw_random_erasing)

    The distributions are the reference's; the bits are numpy's."""
    seeds = [int(s) for s in np.asarray(aug_seed).reshape(-1)]
    H, W = int(hw[0]), int(hw[1])
    batch_rng = np.random.default_rng((seeds[0], 0x5EED)) if batch_ops else None
    ops, bins, signs, gate, b_ops = draw_rand_augment(
        [np.random.default_rng((s, 1)) for s in seeds], num_ops, magnitude, batch_rng,
        timm_levels=True, mstd=mstd, prob=0.5)
    out = {"ra_ops": ops, "ra_bins": bins, "ra_signs": signs, "ra_gate": gate}
    if b_ops is not None:
        out["ra_batch_ops"] = b_ops
    out.update(I.draw_random_erasing([np.random.default_rng((s, 2)) for s in seeds], H, W,
                                   reprob, recount))
    return out


def with_image_draws(batches, **settings):
    """Add :func:`draw_image_aug`'s draws, made with ``settings`` (its
    keywords after ``hw``), to each batch of an iterator of host IMNET
    classification training batches."""
    for batch in batches:
        batch.update(draw_image_aug(batch["aug_seed"], batch["image"].shape[1:3], **settings))
        yield batch


def preprocess_image_cls(batch: dict, is_train: bool, rand_aug: bool = True,
                         reprob: float = 0.25, remode: str = "pixel",
                         generator: torch.Generator | None = None) -> torch.Tensor:
    """The device half of the IMNET classification transform
    (build_transform_e2v's train stack, datasets.py:359-373;
    device_pipeline.py:208-239). Eval returns ``batch["image"]`` as f32,
    untouched (the host already resized and center-cropped). Train: the
    ToUint8 truncation, timm-level RandAugment at prob 0.5 and ToFloat32,
    gated on ``rand_aug`` alone (timm applies ops even at level 0:
    AutoContrast and Equalize ignore the magnitude), then RandomErasing with
    ``remode`` fill from ``generator`` on the batch's device, gated on
    ``reprob`` alone. The random choices are the batch's
    :func:`draw_image_aug` draws: their shapes give the rounds and the boxes,
    and ``ra_batch_ops``, where present, the batch's shared ops. A batch
    without them raises."""
    x = batch["image"].to(torch.float32)
    if not is_train:
        return x
    drawer = "draw_image_aug(batch['aug_seed'], (H, W), ...)"
    if rand_aug:
        ops, bins, signs, gate = _train_draws(batch, ("ra_ops", "ra_bins", "ra_signs",
                                                      "ra_gate"), drawer)
        u8 = (255.0 * x).to(torch.uint8)                    # ToUint8 truncation
        u8 = rand_augment_batch(u8, ops, bins, signs, batch.get("ra_batch_ops"), gate=gate)
        x = u8.to(torch.float32) / 255.0                    # ToFloat32
    if reprob > 0:
        use, box = _train_draws(batch, ("er_use", "er_box"), drawer)
        x = I.random_erasing_batch(x, {"er_use": use, "er_box": box}, remode, generator)
    return x
    drawer = "draw_image_aug(batch['aug_seed'], (H, W), ...)"
    if rand_aug:
        ops, bins, signs, gate = _train_draws(batch, ("ra_ops", "ra_bins", "ra_signs",
                                                      "ra_gate"), drawer)
        if ops.shape[1] != num_ops:
            raise ValueError(f"the batch's RandAugment draws have {ops.shape[1]} rounds, "
                             f"not num_ops {num_ops}")
        b_ops = _train_draws(batch, ("ra_batch_ops",), drawer)[0] if batch_ops else None
        u8 = (255.0 * x).to(torch.uint8)                    # ToUint8 truncation
        u8 = rand_augment_batch(u8, ops, bins, signs, b_ops, gate=gate)
        x = u8.to(torch.float32) / 255.0                    # ToFloat32
    if reprob > 0:
        use, box = _train_draws(batch, ("er_use", "er_box"), drawer)
        if box.shape[1] != recount:
            raise ValueError(f"the batch's erasing draws have {box.shape[1]} boxes, "
                             f"not recount {recount}")
        x = I.random_erasing_batch(x, {"er_use": use, "er_box": box}, remode, generator)
    return x
