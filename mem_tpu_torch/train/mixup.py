"""Mixup / CutMix (timm semantics) for finetuning, port of
mem_tpu/train/mixup.py (:73-184).

The three timm modes: ``batch`` (one lambda, one mixup-or-cutmix choice and
one box per batch), ``elem`` (one of each per sample) and ``pair`` (samples
i and B-1-i share them; the middle sample of an odd batch stays unmixed).
Sample i always mixes with sample B-1-i. ``cutmix_minmax`` replaces the
beta-sampled box by one whose side ratios are uniform in [min, max] and
which lies inside the image. Labels become smoothed one-hot targets mixed
with each row's lambda; a cutmix row's lambda is the exact share of the
image left outside the box.

The port's convention for random draws applies (``draw_train_aug``): the
host draws the parameters in numpy from the step's seed
(:func:`draw_mixup`) with the reference's distributions (uniform for the
``use`` and ``switch`` coins, Beta for both lambdas, uniform integer box
centres), and the mix itself is a plain function of device tensors and
those draws (:func:`mixup_apply`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

MIXUP_KEYS = ("mix_use", "mix_use_cutmix", "mix_lam", "mix_lam_img", "mix_box")


@dataclass(frozen=True)
class MixupConfig:
    num_classes: int
    mixup_alpha: float = 0.8
    cutmix_alpha: float = 1.0
    prob: float = 1.0
    switch_prob: float = 0.5
    label_smoothing: float = 0.1
    mode: str = "batch"
    cutmix_minmax: Optional[Tuple[float, float]] = None

    @property
    def cutmix_on(self) -> bool:
        return self.cutmix_alpha > 0 or self.cutmix_minmax is not None


def make_mixup(num_classes: int, mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
               prob: float = 1.0, switch_prob: float = 0.5, label_smoothing: float = 0.1,
               mode: str = "batch",
               cutmix_minmax: Optional[Sequence[float]] = None) -> Optional[MixupConfig]:
    """The mixup settings, or None when mixup is off (``prob == 0``, or
    neither mixup nor cutmix active), with the reference's argument checks
    (mixup.py:88-94). A set ``cutmix_minmax`` turns cutmix on whatever
    ``cutmix_alpha`` says."""
    cutmix_on = cutmix_alpha > 0 or cutmix_minmax is not None
    if prob <= 0 or (mixup_alpha <= 0 and not cutmix_on):
        return None
    if mode not in ("batch", "pair", "elem"):
        raise ValueError(f"mixup_mode must be batch|pair|elem, got {mode!r}")
    if cutmix_minmax is not None and len(cutmix_minmax) != 2:
        raise ValueError("cutmix_minmax expects exactly 2 values")
    return MixupConfig(num_classes, mixup_alpha, cutmix_alpha, prob, switch_prob,
                       label_smoothing, mode,
                       None if cutmix_minmax is None else tuple(cutmix_minmax))


def rand_bbox(rng: np.random.Generator, h: int, w: int, lam: float):
    """timm ``rand_bbox`` (mixup.py:41-55): a box of area share ~(1 - lam)
    around a uniform centre, clipped at the borders; (y0, y1, x0, x1, the
    lambda of the clipped box)."""
    ratio = np.sqrt(np.float32(1.0) - np.float32(lam))
    cut_h, cut_w = int(np.float32(h) * ratio), int(np.float32(w) * ratio)
    cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
    y0, y1 = np.clip([cy - cut_h // 2, cy + cut_h // 2], 0, h)
    x0, x1 = np.clip([cx - cut_w // 2, cx + cut_w // 2], 0, w)
    return int(y0), int(y1), int(x0), int(x1), 1.0 - (y1 - y0) * (x1 - x0) / float(h * w)


def rand_bbox_minmax(rng: np.random.Generator, h: int, w: int, minmax):
    """timm ``rand_bbox_minmax`` (mixup.py:58-70): side ratios uniform in
    ``minmax``, the box placed uniformly inside the image."""
    cut_h = int(np.float32(h) * np.float32(rng.uniform(minmax[0], minmax[1])))
    cut_w = int(np.float32(w) * np.float32(rng.uniform(minmax[0], minmax[1])))
    y0 = int(rng.integers(0, h - cut_h + 1))
    x0 = int(rng.integers(0, w - cut_w + 1))
    return y0, y0 + cut_h, x0, x0 + cut_w, 1.0 - cut_h * cut_w / float(h * w)


def _draw_one(cfg: MixupConfig, rng: np.random.Generator, h: int, w: int):
    """One parameter set (mixup.py:103-116 and :126-138): use, use_cutmix,
    lam_mix, (y0, y1, x0, x1), lam of the box."""
    use = bool(rng.uniform() < cfg.prob)
    if cfg.mixup_alpha > 0 and cfg.cutmix_on:
        use_cutmix = bool(rng.uniform() < cfg.switch_prob)
    else:
        use_cutmix = cfg.cutmix_on
    lam_mix = float(rng.beta(cfg.mixup_alpha or 1.0, cfg.mixup_alpha or 1.0))
    lam_cut = float(rng.beta(cfg.cutmix_alpha or 1.0, cfg.cutmix_alpha or 1.0))
    if cfg.cutmix_minmax is not None:
        *box, lam_adj = rand_bbox_minmax(rng, h, w, cfg.cutmix_minmax)
    else:
        *box, lam_adj = rand_bbox(rng, h, w, lam_cut)
    return use, use_cutmix, lam_mix, box, lam_adj


def draw_mixup(cfg: MixupConfig, seed, B: int, H: int, W: int) -> dict:
    """Host draws for one batch of B images of (H, W), from
    ``np.random.default_rng(seed)``, as per-row arrays whatever the mode:

      mix_use (B,) bool         the row is mixed at all
      mix_use_cutmix (B,) bool  cutmix rather than mixup
      mix_lam (B,) f32          the target lambda: the box's for a cutmix row,
                                the Beta draw for a mixup row, 1 where unused
      mix_lam_img (B,) f32      the lambda of the mixup blend: the Beta draw in
                                ``batch`` mode, ``mix_lam`` in the others
                                (mixup.py:136 and :170)
      mix_box (B, 4) int32      y0, y1, x0, x1
    """
    rng = np.random.default_rng(seed)
    n = {"batch": 1, "elem": B, "pair": B // 2}[cfg.mode]
    rows = [_draw_one(cfg, rng, H, W) for _ in range(n)]
    use = np.array([r[0] for r in rows], bool)
    use_cutmix = np.array([r[1] for r in rows], bool)
    lam_mix = np.array([r[2] for r in rows], np.float32)
    box = np.array([r[3] for r in rows], np.int32).reshape(n, 4)
    lam = np.where(use, np.where(use_cutmix, np.array([r[4] for r in rows], np.float32),
                                 lam_mix), np.float32(1.0)).astype(np.float32)
    lam_img = lam_mix if cfg.mode == "batch" else lam
    if cfg.mode == "batch":
        use, use_cutmix, lam, lam_img, box = (np.repeat(a, B, axis=0)
                                              for a in (use, use_cutmix, lam, lam_img, box))
    elif cfg.mode == "pair":
        def mirror(v, mid):
            middle = np.full((B % 2,) + v.shape[1:], mid, v.dtype)
            return np.concatenate([v, middle, v[::-1]])

        use, use_cutmix = mirror(use, False), mirror(use_cutmix, False)
        lam, lam_img, box = mirror(lam, 1.0), mirror(lam_img, 1.0), mirror(box, 0)
    return {"mix_use": use, "mix_use_cutmix": use_cutmix, "mix_lam": lam,
            "mix_lam_img": lam_img.astype(np.float32), "mix_box": box}


def one_hot_smoothed(targets: torch.Tensor, num_classes: int, smoothing: float):
    """(1 - eps) * onehot + eps / K: rows sum to 1 (mixup.py:35-38)."""
    off = smoothing / num_classes
    return torch.nn.functional.one_hot(targets.long(), num_classes).float() \
        * (1.0 - smoothing) + off


def mixup_apply(images: torch.Tensor, targets: torch.Tensor, draws: dict, cfg: MixupConfig):
    """(B, H, W, C) images and (B,) integer labels with the draws of
    :func:`draw_mixup` (tensors on the images' device) -> (mixed images,
    (B, num_classes) f32 soft targets), mixup.py:120-184 for every mode."""
    B, H, W, _ = images.shape
    flipped = images.flip(0)
    t1 = one_hot_smoothed(targets, cfg.num_classes, cfg.label_smoothing)

    def col(name):
        return draws[name].reshape(B, 1, 1, 1)

    lam_img = col("mix_lam_img").to(images.dtype)
    mix_imgs = lam_img * images + (1 - lam_img) * flipped
    box = draws["mix_box"].reshape(B, 4, 1, 1, 1)
    ys = torch.arange(H, device=images.device).reshape(1, H, 1, 1)
    xs = torch.arange(W, device=images.device).reshape(1, 1, W, 1)
    in_box = (ys >= box[:, 0]) & (ys < box[:, 1]) & (xs >= box[:, 2]) & (xs < box[:, 3])
    cut_imgs = torch.where(in_box, flipped, images)
    mixed = torch.where(col("mix_use_cutmix"), cut_imgs, mix_imgs)
    mixed = torch.where(col("mix_use"), mixed, images)
    lam = draws["mix_lam"].float().reshape(B, 1)
    return mixed, lam * t1 + (1 - lam) * t1.flip(0)
