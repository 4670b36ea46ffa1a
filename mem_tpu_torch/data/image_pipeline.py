"""Real-image (JPEG) pipeline of the ``--data_set IMNET`` path, the port's own
copy of mem_tpu/data/image_pipeline.py (numpy and PIL, no torch).

Reference surface reproduced here:
  - ``datasets.ImageFolder`` over a JPEG class tree
    (mem/datasets.py:156-157);
  - ``DataAugmentationForPTE2V`` (mem/datasets.py:86-133): per sample,
    ColorJitter(0.4, 0.4, 0.4) -> RandomHorizontalFlip(0.5) ->
    ``RandomResizedCropAndInterpolationWithTwoPic`` producing a bicubic
    (``--train_interpolation``) 224^2 patches view and a lanczos 224^2
    tokenizer view from the SAME crop window (mem/transforms.py:73-187),
    plus a BEiT block mask;
  - ``build_transform_e2v`` (mem/datasets.py:353-392) in classification
    mode: train is RRC + hflip (+ ColorJitter when ``--aa`` is off), eval
    resizes the short side by the crop-pct quirk and center-crops; each
    sample carries an ``aug_seed`` from which the host draws the device's
    RandAugment and RandomErasing (data/device_pipeline.draw_image_aug).

JPEG decode and PIL resampling are per-sample host work. Each sample has its
own ``np.random.Generator`` seeded by (seed, epoch, index); an epoch's order
is a shuffle seeded by seed + epoch. On the same PIL the batches are byte for
byte those of the JAX package's iterator.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from mem_tpu_torch.data.folder import find_classes
from mem_tpu_torch.ops.masking import make_mask_generator

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


class ImageFolder:
    """torchvision ImageFolder-role scan: class dirs -> (path, idx) list."""

    def __init__(self, root: str):
        self.root = root
        self.classes, self.class_to_idx = find_classes(root)
        self.samples: List[Tuple[str, int]] = []
        for cls in self.classes:
            d = os.path.join(root, cls)
            for dirpath, _, files in sorted(os.walk(d)):
                for f in sorted(files):
                    if f.lower().endswith(IMG_EXTENSIONS):
                        self.samples.append((os.path.join(dirpath, f), self.class_to_idx[cls]))
        if not self.samples:
            raise FileNotFoundError(f"no images under {root}")

    def __len__(self):
        return len(self.samples)

    @property
    def nb_classes(self):
        return len(self.classes)


def _color_jitter(img: np.ndarray, rng: np.random.Generator, strength: float) -> np.ndarray:
    """torchvision ColorJitter(b, c, s) semantics: factors uniform in
    [1-s, 1+s], ops applied in a random order, blend-based."""
    img = img.astype(np.float32)
    ops = rng.permutation(3)
    for op in ops:
        f = float(rng.uniform(max(0.0, 1 - strength), 1 + strength))
        if op == 0:      # brightness
            img = img * f
        elif op == 1:    # contrast: blend with mean of grayscale
            gray = img @ np.array([0.299, 0.587, 0.114], np.float32)
            img = f * img + (1 - f) * float(gray.mean())
        else:            # saturation: blend with grayscale
            gray = img @ np.array([0.299, 0.587, 0.114], np.float32)
            img = f * img + (1 - f) * gray[..., None]
        img = np.clip(img, 0, 255)
    return img


def _pil_filter(name: str, rng: np.random.Generator):
    from PIL import Image

    if name == "random":  # torchvision _RANDOM_INTERPOLATION
        return (Image.BILINEAR, Image.BICUBIC)[int(rng.integers(2))]
    return {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC,
            "lanczos": Image.LANCZOS, "nearest": Image.NEAREST}[name]


def rrc_params(w: int, h: int, rng: np.random.Generator,
               scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0)):
    """RandomResizedCrop window: the 10-attempt rejection loop and the
    central fallback (mem/transforms.py:112-154). Returns (i, j, ch, cw)
    with i = row, j = col."""
    area = w * h
    for _ in range(10):
        target_area = rng.uniform(*scale) * area
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if cw <= w and ch <= h:
            i = int(rng.integers(0, h - ch + 1))
            j = int(rng.integers(0, w - cw + 1))
            return i, j, ch, cw
    in_ratio = w / h
    if in_ratio < min(ratio):
        cw = w
        ch = int(round(cw / min(ratio)))
    elif in_ratio > max(ratio):
        ch = h
        cw = int(round(ch * max(ratio)))
    else:
        cw, ch = w, h
    return (h - ch) // 2, (w - cw) // 2, ch, cw


@dataclass
class ImagePipelineConfig:
    """The reference's ImagePipelineConfig (:121) without its sharding and
    worker fields: the port reads every sample on one process, inline."""
    batch_size: int = 64
    input_size: int = 224
    second_size: int = 224
    # the two views' filters (transforms.py:94): bilinear|bicubic|lanczos|
    # nearest, or 'random' = a per-sample bilinear/bicubic choice
    interpolation: str = "bicubic"
    second_interpolation: str = "lanczos"
    color_jitter: float = 0.4
    scale: Tuple[float, float] = (0.08, 1.0)
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)
    masking: Optional[str] = "block"
    window_size: Tuple[int, int] = (14, 14)
    num_mask_patches: int = 98
    min_mask_patches_per_block: int = 16
    max_mask_patches_per_block: Optional[int] = None
    is_train: bool = True
    seed: int = 0
    shuffle: bool = True
    drop_last: bool = True
    # classification mode (build_transform_e2v): one view, the label and a
    # per-sample aug_seed; no mask, no second view
    classification: bool = False
    color_jitter_cls: float = 0.0  # train: honoured only when --aa is off
    use_color_jitter_cls: bool = False


class ImageBatchIterator:
    """The EventBatchIterator surface: ``steps_per_epoch()`` and ``epoch(e)``
    yielding fixed-shape numpy batches: {patches, vae_view, label[, mask]}
    in two-view mode, {image, label, aug_seed} in classification mode."""

    def __init__(self, ds: ImageFolder, cfg: ImagePipelineConfig):
        self.ds = ds
        self.cfg = cfg
        self._maskgen = None
        if cfg.masking:
            self._maskgen = make_mask_generator(
                cfg.masking, cfg.window_size, cfg.num_mask_patches,
                min_num_patches=cfg.min_mask_patches_per_block,
                max_num_patches=cfg.max_mask_patches_per_block)

    def steps_per_epoch(self) -> int:
        n = len(self._epoch_indices(0))
        b = self.cfg.batch_size
        return n // b if self.cfg.drop_last else -(-n // b)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.cfg.shuffle:
            np.random.default_rng(self.cfg.seed + epoch).shuffle(idx)
        return idx

    def _load_one_cls(self, epoch: int, index: int):
        """build_transform_e2v (datasets.py:353-392): train = timm-style RRC +
        hflip [+ ColorJitter when no AA spec]; eval = short-side resize by the
        crop_pct quirk (379-382: always 224/256 below 384), then a center
        crop. mean/std are (0,0,0)/(1,1,1) there: identity."""
        from PIL import Image

        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, epoch, index))
        path, label = self.ds.samples[index]
        img = Image.open(path).convert("RGB")
        s = cfg.input_size

        if cfg.is_train:
            i, j, ch, cw = rrc_params(img.size[0], img.size[1], rng, cfg.scale, cfg.ratio)
            img = img.resize((s, s), _pil_filter(cfg.interpolation, rng),
                             box=(j, i, j + cw, i + ch))
            if rng.random() < 0.5:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
            if cfg.use_color_jitter_cls and cfg.color_jitter_cls > 0:
                # timm create_transform: ColorJitter comes AFTER RRC + flip, so
                # contrast blends toward the crop's mean, not the image's
                arr = _color_jitter(np.asarray(img, np.float32), rng, cfg.color_jitter_cls)
                img = Image.fromarray(arr.astype(np.uint8))
        else:
            crop_pct = 224 / 256 if s < 384 else 1.0  # quirk: the flag is ignored
            short = int(s / crop_pct)
            w, h = img.size
            if w <= h:
                nw, nh = short, max(1, round(h * short / w))
            else:
                nw, nh = max(1, round(w * short / h)), short
            img = img.resize((nw, nh), Image.BICUBIC)  # interpolation=3
            left, top = (nw - s) // 2, (nh - s) // 2
            img = img.crop((left, top, left + s, top + s))

        return {
            "image": np.asarray(img, np.float32) / 255.0,
            "label": np.int64(label),
            "aug_seed": np.uint32(rng.integers(0, 2**32 - 1)),
        }

    def _load_one(self, epoch: int, index: int):
        from PIL import Image

        cfg = self.cfg
        if cfg.classification:
            return self._load_one_cls(epoch, index)
        rng = np.random.default_rng((cfg.seed, epoch, index))
        path, label = self.ds.samples[index]
        img = Image.open(path).convert("RGB")

        if cfg.is_train and cfg.color_jitter > 0:
            arr = _color_jitter(np.asarray(img, np.float32), rng, cfg.color_jitter)
            img = Image.fromarray(arr.astype(np.uint8))
        if cfg.is_train and rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)

        i, j, ch, cw = rrc_params(img.size[0], img.size[1], rng, cfg.scale, cfg.ratio)
        box = (j, i, j + cw, i + ch)
        s1, s2 = cfg.input_size, cfg.second_size
        patches = img.resize((s1, s1), _pil_filter(cfg.interpolation, rng), box=box)
        vae_view = img.resize((s2, s2), _pil_filter(cfg.second_interpolation, rng), box=box)

        out = {
            "patches": np.asarray(patches, np.float32) / 255.0,
            "vae_view": np.asarray(vae_view, np.float32) / 255.0,
            "label": np.int64(label),
        }
        if self._maskgen is not None:
            out["mask"] = self._maskgen(rng).reshape(-1).astype(bool)
        return out

    def epoch(self, epoch: int) -> Iterator[dict]:
        cfg = self.cfg
        idx = self._epoch_indices(epoch)
        nb = len(idx) // cfg.batch_size if cfg.drop_last else -(-len(idx) // cfg.batch_size)
        for b in range(nb):
            chunk = idx[b * cfg.batch_size: (b + 1) * cfg.batch_size]
            if len(chunk) < cfg.batch_size:  # pad by wrapping (eval only)
                chunk = np.concatenate([chunk, idx[: cfg.batch_size - len(chunk)]])
            samples = [self._load_one(epoch, int(i)) for i in chunk]
            yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}
