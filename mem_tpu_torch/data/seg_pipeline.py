"""DSEC semantic-segmentation data pipeline.

Port of mem_tpu/data/seg_pipeline.py. The host side is the reference's own
(EventDataset/LoadNpy flow, EventDataset.py:711-763 + dsec.py pipeline):
scan (events .npy, label .png) pairs, load + crop events to y < 440 with
p -> +-1 (dsec loader semantics), SliceRandomMaxEvs(180000) as a host
memcpy, the y presort, pad, and sample per-item randomness, through the
numpy loader or the threaded C++ one (native/memev.cpp). The batches are
the reference's array for array, for training as for evaluation.

The device side, ``seg_preprocess_batch``:

  voxelize 440x640 (uint8 counts; kernel K4 through ops/voxelize.py) ->
  [train: Resize ratio_range + RandomCrop as one window resample] ->
  RemoveHotPixelsEvs (count scale) -> NormalizeEvs (/max * 255) ->
  [train: ToUint8 -> EventRandAugmentEvs (photometric only, magnitude 10)]
  -> float32 0..255 -> [train: RandomFlip] (the mmseg Normalize step is
  mean 0 / std 1, i.e. identity: the network consumes 0..255 inputs;
  dsec.py:1-24).

The RandAugment draws, which the reference makes on the device from
``jax.random`` keys built from each sample's ``aug_seed``, are made on the
host from the same ``aug_seed`` by :func:`draw_seg_train_aug` (numpy, the
same distributions) and ride in the batch, so the CPU and the card augment
a batch identically; the flips and the resize jitter are host draws the
iterator already emits.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from mem_tpu_torch import native
from mem_tpu_torch.data.device_pipeline import events_f32
from mem_tpu_torch.ops import image_ops as I
from mem_tpu_torch.ops.rand_augment import draw_rand_augment, rand_augment_batch
from mem_tpu_torch.ops.voxelize import voxelize_fused

SEG_H, SEG_W = 440, 640
SEG_MAX_EVS = 180000  # EventDataset.py:726
IGNORE_INDEX = 255
SEG_RAND_AUG_NUM_OPS, SEG_RAND_AUG_MAGNITUDE = 2, 10   # seg_pipeline.py:369


def scan_seg_pairs(data_root: str, img_dir: str, ann_dir: str,
                   img_suffix: str = ".npy", seg_suffix: str = ".png"):
    pairs: List[Tuple[str, str]] = []
    base = os.path.join(data_root, img_dir)
    for dirpath, _, files in sorted(os.walk(base)):
        for f in sorted(files):
            if not f.endswith(img_suffix):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), base)
            ann = os.path.join(data_root, ann_dir, rel[: -len(img_suffix)] + seg_suffix)
            if os.path.exists(ann):
                pairs.append((os.path.join(dirpath, f), ann))
    if not pairs:
        raise FileNotFoundError(f"no (img, ann) pairs under {base}")
    return pairs


def load_seg_label(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path), dtype=np.uint8)


@dataclass
class SegPipelineConfig:
    batch_size: int = 16
    is_train: bool = True
    max_evs: int = SEG_MAX_EVS
    seed: int = 0
    num_workers: int = 4
    shard_id: int = 0
    num_shards: int = 1
    flip_prob: float = 0.5
    # int16 [x, y, p] wire format (t is dead: the seg raster never builds a
    # time surface) — 2.7x less host->device traffic (see data/pipeline.py)
    compact_wire: bool = True
    # mmseg Resize ratio_range (dsec.py:13) + RandomCrop back to (H, W);
    # None disables (eval pipelines are single-scale identity, dsec.py:32-34)
    ratio_range: Optional[Tuple[float, float]] = (1.0, 1.01)
    # host presort by y after slicing: the wide-canvas histogram (kernel K4,
    # ops/voxelize_hist.py) counts y-sorted events by row bands: presorting
    # here saves its sort on the device. Histogram counts are
    # order-invariant and the seg raster has no time surface, so this is
    # semantically free (the downstream hflip acts on the IMAGE).
    presort_y: bool = True
    # libmemev threaded crop+slice+counting-sort+int16-pack fast path
    # (native/memev.cpp memev_load_batch_dsec); label PNGs stay on PIL
    use_native: bool = True


class SegBatchIterator:
    """Infinite iter-based sampling (the reference trains by iteration count,
    schedule_160k.py) over (events, label) pairs."""

    def __init__(self, pairs, config: SegPipelineConfig):
        self.pairs = pairs
        self.cfg = config

    def __len__(self):
        return len(self.pairs)

    def _load_one(self, rng: np.random.Generator, index: int) -> dict:
        img_path, ann_path = self.pairs[index]
        # crop/slice BEFORE the full dtype convert + polarity remap so those
        # passes touch only the kept <=180k rows (about half the loader work). The
        # crop compares the f32-ROUNDED y (one cheap column cast) so a f64
        # y in (440-ulp, 440) cannot round up into an out-of-range raster
        # row after the convert, and rejects negative/NaN y (corrupt data)
        # instead of letting it reach the device kernel — same predicate as
        # the native loader (memev.cpp memev_load_npy_dsec); deviation from
        # the reference's bare `y < 440` (dataset_folder.py:275-283).
        raw = np.load(img_path)
        y32 = raw[:, 1].astype(np.float32)
        raw = raw[(y32 >= 0) & (y32 < SEG_H)]
        n = raw.shape[0]
        cap = self.cfg.max_evs
        if n > cap:
            start = int(rng.integers(0, n - cap + 1))
            raw = raw[start : start + cap]
            n = cap
        ev = raw.astype(np.float32)
        ev[:, 3] = 2 * ev[:, 3] - 1
        if self.cfg.presort_y:
            ev = ev[np.argsort(ev[:, 1])]
        label = load_seg_label(ann_path)
        item = {
            "events": ev,
            "n_valid": np.int32(n),
            "label": label,
            "flip": np.bool_(self.cfg.is_train and rng.random() < self.cfg.flip_prob),
            "aug_seed": rng.integers(0, 2**31 - 1, dtype=np.int64).astype(np.uint32),
        }
        if self.cfg.is_train and self.cfg.ratio_range is not None:
            # mmseg random_sample_ratio + rescale_size int(x * r + 0.5)
            # (transforms.py Resize) then RandomCrop offset in [0, margin]
            r = rng.uniform(*self.cfg.ratio_range)
            hs, ws = int(SEG_H * r + 0.5), int(SEG_W * r + 0.5)
            oy = int(rng.integers(0, hs - SEG_H + 1))
            ox = int(rng.integers(0, ws - SEG_W + 1))
            item["resize_jitter"] = np.array(
                [hs / SEG_H, ws / SEG_W, oy, ox], np.float32)
        return item

    def _native_eligible(self) -> bool:
        cfg = self.cfg
        if not (cfg.use_native and cfg.compact_wire and cfg.presort_y):
            return False
        return native.available()

    def _load_batch_native(self, rngs, idxs) -> dict:
        """Threaded C++ crop+slice+counting-sort+int16 pack (the bulk of
        the python batch's work); per-sample aug randomness stays host-drawn.
        Like the classification native path, the slice rng stream differs
        from the python path's (frac pre-drawn unconditionally) — both
        deterministic under the (seed, iter, index) convention."""
        cfg = self.cfg
        paths = [self.pairs[int(i)][0] for i in idxs]
        fracs = [r.random() for r in rngs]
        events, n_valid = native.load_batch_dsec(
            paths, fracs, cfg.max_evs, SEG_H,
            num_threads=max(cfg.num_workers, 1))
        labels = np.stack([load_seg_label(self.pairs[int(i)][1])
                           for i in idxs]).astype(np.int32)
        batch = {
            "events_xyp": events,
            "n_valid": n_valid,
            "label": labels,
            "flip": np.array([cfg.is_train and r.random() < cfg.flip_prob
                              for r in rngs]),
            "aug_seed": np.stack([
                r.integers(0, 2**31 - 1, dtype=np.int64).astype(np.uint32)
                for r in rngs]),
        }
        if cfg.is_train and cfg.ratio_range is not None:
            jit = []
            for r in rngs:
                ratio = r.uniform(*cfg.ratio_range)
                hs = int(SEG_H * ratio + 0.5)
                ws = int(SEG_W * ratio + 0.5)
                oy = int(r.integers(0, hs - SEG_H + 1))
                ox = int(r.integers(0, ws - SEG_W + 1))
                jit.append(np.array([hs / SEG_H, ws / SEG_W, oy, ox],
                                    np.float32))
            batch["resize_jitter"] = np.stack(jit)
        return batch

    def batches(self, start_iter: int = 0) -> Iterator[dict]:
        cfg = self.cfg
        order_rng = np.random.default_rng(cfg.seed)
        order = []
        it = start_iter
        native_ok = self._native_eligible()
        while True:
            while len(order) < cfg.batch_size:
                idx = np.arange(len(self.pairs))
                order_rng.shuffle(idx)
                order.extend(idx[cfg.shard_id :: cfg.num_shards].tolist())
            take, order = order[: cfg.batch_size], order[cfg.batch_size :]
            # per-sample rng keyed by (seed, iter, DATASET index) — the
            # repo-wide host-randomness convention. Keying by batch slot
            # would make sample augmentation depend on which process/slot
            # drew it, breaking process-count invariance (the multi-process
            # run must equal the single-process run, tests/test_multiprocess)
            rngs = [np.random.default_rng((cfg.seed, it, int(i)))
                    for i in take]
            if native_ok:
                try:
                    yield self._load_batch_native(rngs, take)
                    it += 1
                    continue
                except IOError:
                    # corrupt/odd file: retry on the python path with FRESH
                    # rng streams (the native attempt consumed draws)
                    rngs = [np.random.default_rng((cfg.seed, it, int(i)))
                            for i in take]
            items = [self._load_one(r, int(i)) for r, i in zip(rngs, take)]
            yield self._collate(items)
            it += 1

    def eval_batches(self) -> Iterator[dict]:
        cfg = self.cfg
        idx = np.arange(len(self.pairs))[cfg.shard_id :: cfg.num_shards]
        for i in range(0, len(idx), cfg.batch_size):
            chunk = idx[i : i + cfg.batch_size].tolist()
            # per-index rng (eval uses it only for the over-cap crop start):
            # deterministic per SAMPLE, independent of shard/process layout.
            # 2**32 - 1 = an "epoch" sentinel train iteration counts never
            # reach (SeedSequence entries must be non-negative)
            n_real = len(chunk)
            # pad by duplicating the last index: its (seed, sentinel, idx)
            # rng reproduces identical rows, matching the item-duplication
            # of the python path
            full = chunk + [chunk[-1]] * (cfg.batch_size - n_real)
            rngs = [np.random.default_rng((cfg.seed, 2**32 - 1, int(j)))
                    for j in full]
            if self._native_eligible():
                try:
                    b = self._load_batch_native(rngs, full)
                    b["n_real"] = np.int32(n_real)
                    yield b
                    continue
                except IOError:
                    rngs = [np.random.default_rng(
                        (cfg.seed, 2**32 - 1, int(j))) for j in full]
            items = [self._load_one(r, int(j)) for r, j in zip(rngs, full)]
            b = self._collate(items)
            b["n_real"] = np.int32(n_real)
            yield b

    def _collate(self, items) -> dict:
        B = len(items)
        batch = {
            "n_valid": np.stack([it["n_valid"] for it in items]),
            "label": np.stack([it["label"] for it in items]).astype(np.int32),
            "flip": np.stack([it["flip"] for it in items]),
            "aug_seed": np.stack([it["aug_seed"] for it in items]),
        }
        if "resize_jitter" in items[0]:
            batch["resize_jitter"] = np.stack(
                [it["resize_jitter"] for it in items])
        if self.cfg.compact_wire:
            # pack straight into the int16 wire buffer with per-column
            # sliced stores (same trick as data/pipeline.py) — the previous
            # f32-staging + fancy-index + ascontiguousarray + astype chain
            # made three extra passes over a 46 MB intermediate
            exyp = np.zeros((B, self.cfg.max_evs, 3), np.int16)
            for i, it in enumerate(items):
                e = it["events"]
                m = len(e)
                exyp[i, :m, 0] = e[:, 0]
                exyp[i, :m, 1] = e[:, 1]
                exyp[i, :m, 2] = e[:, 3]
            batch["events_xyp"] = exyp
        else:
            events = np.zeros((B, self.cfg.max_evs, 4), np.float32)
            for i, it in enumerate(items):
                events[i, : len(it["events"])] = it["events"]
            batch["events"] = events
        return batch


def _interp_matrices(n: int, r, o, nearest: bool):
    """(B, n, n) resample matrices M with out = M @ in for one axis, from
    per-sample ratios ``r`` and offsets ``o`` (B,): output cell i samples
    the input coordinate (i + o + 0.5) / r - 0.5 (center-aligned "resize by
    r, then crop at offset o"), edge-replicated. Bilinear rows hold two
    banded weights; nearest rows are one-hot (seg_pipeline.py:298-314)."""
    i = torch.arange(n, dtype=torch.float32, device=r.device)
    cc = torch.clamp((i[None] + o[:, None] + 0.5) / r[:, None] - 0.5, 0.0, n - 1.0)

    def one_hot(idx):
        return torch.nn.functional.one_hot(idx, n).to(torch.float32)

    if nearest:
        return one_hot(torch.round(cc).long())
    c0 = torch.floor(cc)
    w = cc - c0
    c0i = c0.long()
    c1i = torch.clamp(c0i + 1, max=n - 1)
    return one_hot(c0i) * (1.0 - w)[..., None] + one_hot(c1i) * w[..., None]


def apply_resize_jitter(img, labels, rj):
    """mmseg Resize(ratio_range) + RandomCrop as one resample of the raster
    (bilinear) and of the labels (nearest), two batched products per axis
    (seg_pipeline.py:317-329). ``rj``: (B, 4) f32 [r_h, r_w, oy, ox]."""
    H, W = img.shape[1], img.shape[2]
    ay = _interp_matrices(H, rj[:, 0], rj[:, 2], False)
    ax = _interp_matrices(W, rj[:, 1], rj[:, 3], False)
    img = torch.einsum("bij,bjxc->bixc", ay, img)
    img = torch.einsum("bwx,bixc->biwc", ax, img)
    py = _interp_matrices(H, rj[:, 0], rj[:, 2], True)
    px = _interp_matrices(W, rj[:, 1], rj[:, 3], True)
    lab = torch.einsum("bij,bjx->bix", py, labels.to(torch.float32))
    lab = torch.einsum("bwx,bix->biw", px, lab)
    return img, torch.round(lab).to(labels.dtype)


def draw_seg_train_aug(aug_seed: np.ndarray, rand_aug_batch_ops: bool = False) -> dict:
    """Host draws of the training RandAugment for one batch, from each
    sample's ``aug_seed`` (a ``np.random.default_rng(seed)`` per sample):
    ``ra_ops`` (one of the 9 photometric-pool ops), ``ra_bins`` in [0, 10]
    and ``ra_signs`` in {0, 1}, (B, 2) int32, and with ``rand_aug_batch_ops``
    the (2,) ``ra_batch_ops`` shared by the batch, drawn from (aug_seed[0],
    0x5EED) (rand_augment.py:413). The distributions are the reference's;
    the bits are numpy's. ``ra_batch_ops`` is read back by the host and stays
    numpy (data/prefetch.py keeps it off the device)."""
    seeds = [int(s) for s in np.asarray(aug_seed).reshape(-1)]
    rngs = [np.random.default_rng(s) for s in seeds]
    batch_rng = np.random.default_rng((seeds[0], 0x5EED)) if rand_aug_batch_ops else None
    ops, bins, signs, _, batch_ops = draw_rand_augment(
        rngs, SEG_RAND_AUG_NUM_OPS, SEG_RAND_AUG_MAGNITUDE, batch_rng, geometric=False)
    out = {"ra_ops": ops, "ra_bins": bins, "ra_signs": signs}
    if batch_ops is not None:
        out["ra_batch_ops"] = batch_ops
    return out


def seg_preprocess_batch(batch: dict, is_train: bool, rand_aug: bool = True,
                         rand_aug_batch_ops: bool = False, y_sorted: bool = False):
    """On the batch's device: events -> network-ready (B, 440, 640, 3) f32 in
    0..255, plus the labels (flipped with the image when training). Returns
    (images, labels); a label-free batch (serving) returns labels None.
    ``y_sorted`` promises host-presorted events: K4 skips by chunk.
    Training with ``rand_aug`` needs the :func:`draw_seg_train_aug` draws in
    the batch."""
    img = voxelize_fused(
        events_f32(batch), batch["n_valid"], SEG_H, SEG_W,
        time_surface=False, wrap_uint8=True, y_sorted=y_sorted,
    ).to(torch.float32)                                   # counts 0..255
    labels = batch.get("label")
    if is_train and "resize_jitter" in batch:
        # reference order: Resize rides before RemoveHotPixels (dsec.py:13-15)
        img, labels = apply_resize_jitter(img, labels, batch["resize_jitter"])
    img = I.remove_hot_pixels(img, 10.0)                  # RemoveHotPixelsEvs
    # NormalizeEvs: joint max over all channels -> scale to 0..255
    m = img.amax(dim=(1, 2, 3), keepdim=True)
    img = img / torch.where(m > 0, m, torch.ones_like(m)) * 255.0
    if is_train:
        u8 = img.to(torch.uint8)                          # ToUnit8Evs
        if rand_aug:
            keys = ("ra_ops", "ra_bins", "ra_signs") + \
                (("ra_batch_ops",) if rand_aug_batch_ops else ())
            missing = [k for k in keys if k not in batch]
            if missing:
                raise ValueError(
                    f"seg_preprocess_batch(is_train=True, rand_aug=True) needs the host "
                    f"draws {missing}: add draw_seg_train_aug(batch['aug_seed'], "
                    f"rand_aug_batch_ops) to the batch")
            u8 = rand_augment_batch(u8, batch["ra_ops"], batch["ra_bins"], batch["ra_signs"],
                                    batch["ra_batch_ops"] if rand_aug_batch_ops else None,
                                    geometric=False)
        img = u8.to(torch.float32)
        flip = batch["flip"][:, None, None]
        img = torch.where(flip[..., None], img.flip(2), img)
        labels = torch.where(flip, labels.flip(2), labels)
    return img, labels
