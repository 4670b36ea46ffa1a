"""Host ingest pipeline: decode + pad raw event tensors, sample augmentation
randomness; all compute happens on the device.

Port of mem_tpu/data/pipeline.py (PipelineConfig, EventBatchIterator) on the
port's own host modules data/folder.py and native/, with the
masking generators from the port's ops/masking.py. The batches are the
reference's array for array: the same per-sample rng (seed, epoch, index),
the same mask pool, ``_collate``, the native C++ fast path and the compact
int16 wire. The host only
  1. loads the ``.npy`` event array (IO-bound, overlapped with a thread pool),
  2. applies SliceRandomMaxEvs as a contiguous numpy slice,
  3. pads to the static event capacity and records ``n_valid``,
  4. samples per-sample augmentation parameters (flip coins, shift offsets,
     the ``aug_seed`` of the device-side augmentations) and the BEiT mask.
"""
from __future__ import annotations

import concurrent.futures as cf
import time
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from mem_tpu_torch import native
from mem_tpu_torch.data.folder import (NpyFolder, caltech_npy_loader, imgnet_columns_loader,
                                       is_event_columns, ncars_npy_loader)
from mem_tpu_torch.ops.masking import make_mask_generator


@dataclass
class PipelineConfig:
    batch_size: int = 32
    slice_max_evs: int = 30000
    is_train: bool = True
    # event-level augs (train only)
    max_random_shift_evs: int = 0
    flip_x_prob: float = 0.5
    time_flip_prob: float = 0.5
    # variable-resolution datasets (caltech): canvas the rasterizer uses
    sample_hw_from_data: bool = True
    canvas_h: int = 256
    canvas_w: int = 256
    fixed_hw: Optional[tuple] = None        # (H, W) for ncars=None, dsec=(440,640)
    # imagenet path: pre-scale coords
    scale_xy: Optional[tuple] = None        # (sx, sy) applied to x,y columns
    # masking (pretraining only)
    masking: Optional[str] = None           # block | random | None
    mask_pool_size: int = 0                 # >0: pre-generate and sample masks
    window_size: tuple = (14, 14)
    num_mask_patches: int = 98
    min_mask_patches_per_block: int = 16
    max_mask_patches_per_block: Optional[int] = None
    seed: int = 0
    shuffle: bool = True
    drop_last: bool = True
    num_workers: int = 4
    use_native: bool = True   # libmemev threaded batch loader when eligible
    # compact wire format: ship events as (B, N, 3) int16 [x, y, p]
    # ("events_xyp") instead of (B, N, 4) f32 — 2.7x less host->device
    # traffic. Only valid when the t column is dead (time surface off);
    # cli/common gates it. With scale_xy set (N-ImageNet) the wire carries
    # the RAW integer sensor coords and ReshapeScaleXandY moves on-device
    # (PreprocConfig.scale_xy_rational) — bit-identical results, see
    # device_pipeline.events_f32. Requires fixed_hw (sample extents must
    # not be inferred from the unscaled coords).
    compact_wire: bool = False
    # multi-host sharding
    shard_id: int = 0
    num_shards: int = 1
    # per-item load/transform timers (the reference's dead `profile`
    # feature, dataset_folder.py:203-227 — prints k-items/sec per sample);
    # scripts/bench_host_loader.py is the aggregate-stats successor
    profile: bool = False


class EventBatchIterator:
    """Iterates dict batches of padded events + aug params over one dataset."""

    def __init__(self, dataset: NpyFolder, config: PipelineConfig):
        self.ds = dataset
        self.cfg = config
        # compact + scale_xy: ship raw integer coords, scale on-device
        # (device_pipeline.events_f32 scale_xy_rational — bit-identical)
        self._defer_scale = (config.compact_wire
                             and config.scale_xy is not None)
        if self._defer_scale and config.fixed_hw is None:
            raise ValueError(
                "compact_wire with scale_xy requires fixed_hw: sample "
                "extents cannot be inferred from the unscaled coordinates")
        self.mask_gen = None
        self._mask_pool = None
        if config.masking:
            self.mask_gen = make_mask_generator(
                config.masking,
                config.window_size,
                config.num_mask_patches,
                min_num_patches=config.min_mask_patches_per_block,
                max_num_patches=config.max_mask_patches_per_block,
            )
            if config.mask_pool_size > 0:
                # pre-generated mask pool (SURVEY §7): the BEiT rejection loop
                # is the host loader's hot spot on weak cores; sampling from a
                # large fixed pool is statistically equivalent for training
                pool_rng = np.random.default_rng((config.seed, 0x3A5C))
                self._mask_pool = np.stack([
                    self.mask_gen(pool_rng).reshape(-1).astype(bool)
                    for _ in range(config.mask_pool_size)
                ])
        self._pool = (
            cf.ThreadPoolExecutor(config.num_workers)
            if config.num_workers > 0
            else None
        )

    def steps_per_epoch(self) -> int:
        n = len(self._epoch_indices(0))
        b = self.cfg.batch_size
        return n // b if self.cfg.drop_last else -(-n // b)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.cfg.shuffle:
            np.random.default_rng(self.cfg.seed + epoch).shuffle(idx)
        return idx[self.cfg.shard_id :: self.cfg.num_shards]

    def _load_one(self, epoch: int, index: int):
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, epoch, index))
        if cfg.profile:
            t0 = time.perf_counter()
        events, label = self.ds[index]
        if cfg.profile:
            # per-item rate prints, dataset_folder.py:214-216
            print(f"Loading {1/(time.perf_counter()-t0)/1e3} k-items/sec")
            t0 = time.perf_counter()
        cap = cfg.slice_max_evs
        def materialize(events):
            if not is_event_columns(events):
                events = np.asarray(events, dtype=np.float64)
                if events.ndim != 2 or events.shape[1] != 4:
                    events = events.reshape(-1, 4)

                if cfg.scale_xy is not None and not self._defer_scale:
                    events = events.copy()
                    events[:, 0] *= cfg.scale_xy[0]
                    events[:, 1] *= cfg.scale_xy[1]

                # SliceRandomMaxEvs (host memcpy; applied train AND eval like
                # the reference, datasets.py:611-660)
                n = events.shape[0]
                if n > cap:
                    start = int(rng.integers(0, n - cap + 1))
                    events = events[start : start + cap]
                    n = cap
                return events, n

            # column-form samples (N-ImageNet structured/.npz): take the
            # SliceRandomMaxEvs window on the COLUMNS first, then build the
            # (n, 4) array from only the surviving rows. Elementwise
            # rescale/remap commute with row selection and the x/y rescale
            # still multiplies in f64 before the single f32 round, so
            # batches are bit-identical to the eager reference path
            # (imgnet_npy_loader); the rng draw order is unchanged.
            cols = events
            lazy = hasattr(cols, "column")   # LazyNpzColumns byte-range IO
            if lazy:
                n = cols.n
                xfull = None
            else:
                # read x once: np.load NpzFile __getitem__ inflates the whole
                # member per access, so len-probe + slice must share one read
                xfull = cols["x"]
                n = xfull.shape[0]
            if n > cap:
                start = int(rng.integers(0, n - cap + 1))
                sl = slice(start, start + cap)
                n = cap
            else:
                sl = slice(0, n)

            def col(name):
                if lazy:
                    return cols.column(name, sl)
                return (xfull if name == "x" else cols[name])[sl]

            ev = np.empty((n, 4), np.float32)
            xs = col("x").astype(np.float64)
            ys = col("y").astype(np.float64)
            if cfg.scale_xy is not None and not self._defer_scale:
                xs *= cfg.scale_xy[0]
                ys *= cfg.scale_xy[1]
            ev[:, 0] = xs
            ev[:, 1] = ys
            ev[:, 2] = col("t")
            ev[:, 3] = col("p").astype(np.int8) * 2 - 1
            return ev, n

        # Lazy column loaders (LazyNpzColumns / NpzFile) defer the file
        # reads into materialize(); a corrupt payload discovered there must
        # resample another item exactly like an in-loader failure does
        # (dataset_folder.py:206-213 — the reference's eager loaders do all
        # IO inside the retried loader call).
        # catch only corrupt-DATA exception classes: a deterministic
        # programming error (bad cfg, API change) must surface its own
        # traceback, not be re-raised as "too many corrupt samples" after
        # 100 wasted re-loads
        first_err = None
        for _ in range(100):
            try:
                events, n = materialize(events)
                break
            except (ValueError, OSError, KeyError, EOFError) as e:
                if first_err is None:
                    first_err = e
                    print(f"pipeline: corrupt column payload ({e!r}); "
                          f"resampling")
                if hasattr(self.ds, "resample"):
                    events, label = self.ds.resample()
                else:
                    events, label = self.ds[int(rng.integers(0, len(self.ds)))]
        else:
            raise RuntimeError(
                "too many corrupt samples (column payloads); first error: "
                f"{first_err!r}")

        # per-sample logical extents (the reference infers W=max_x+1 when the
        # dataset has no fixed resolution, datasets.py:555-575)
        if cfg.fixed_hw is not None:
            sh, sw = cfg.fixed_hw
        elif cfg.sample_hw_from_data and n > 0:
            sw = int(events[:, 0].max()) + 1
            sh = int(events[:, 1].max()) + 1
        else:
            sh, sw = cfg.canvas_h, cfg.canvas_w
        sh = min(sh, cfg.canvas_h)
        sw = min(sw, cfg.canvas_w)

        out = {
            "events": events.astype(np.float32),
            "n_valid": np.int32(n),
            "label": np.int64(label),
            "sample_h": np.int32(sh),
            "sample_w": np.int32(sw),
        }
        if cfg.is_train:
            out["time_flip"] = np.bool_(rng.random() < cfg.time_flip_prob)
            out["x_flip"] = np.bool_(rng.random() < cfg.flip_x_prob)
            if cfg.max_random_shift_evs > 0:
                out["shift_xy"] = rng.integers(
                    -cfg.max_random_shift_evs,
                    cfg.max_random_shift_evs + 1,
                    size=(2,),
                ).astype(np.int32)
            else:
                out["shift_xy"] = np.zeros((2,), np.int32)
        else:
            out["time_flip"] = np.bool_(False)
            out["x_flip"] = np.bool_(False)
            out["shift_xy"] = np.zeros((2,), np.int32)
        # seed for all on-chip per-sample randomness (crop/RandAugment/jitter)
        out["aug_seed"] = rng.integers(0, 2**31 - 1, dtype=np.int64).astype(np.uint32)
        if self.mask_gen is not None:
            out["mask"] = self._sample_mask(rng)
        if cfg.profile:
            # the reference's "Transforming" half (dataset_folder.py:224-226)
            # covers its host transform chain; here that is the slice/extent/
            # mask work above — the photometric chain runs on-chip
            print(f"Transforming {1/(time.perf_counter()-t0)/1e3} k-items/sec")
        return out

    def _sample_mask(self, rng: np.random.Generator) -> np.ndarray:
        if self._mask_pool is not None:
            return self._mask_pool[int(rng.integers(0, len(self._mask_pool)))]
        return self.mask_gen(rng).reshape(-1).astype(bool)

    def _collate(self, items):
        cap = self.cfg.slice_max_evs
        B = len(items)
        # empty + explicit tail-zero: most samples fill the whole cap, so
        # zeros() would zero-fill 61 MB (B=128 x 30k) just to overwrite it
        events = np.empty((B, cap, 4), np.float32)
        for i, it in enumerate(items):
            e = it["events"]
            events[i, : len(e)] = e
            events[i, len(e):] = 0.0
        batch = {"events": events}
        for k in items[0]:
            if k == "events":
                continue
            batch[k] = np.stack([it[k] for it in items])
        return batch

    def _native_eligible(self) -> bool:
        """The libmemev fast path handles raw-(N,4)-npy datasets without
        coordinate rescaling (caltech/ncars) and, round 4, N-ImageNet
        ZIP_STORED .npz column samples (incl. the ReshapeScaleXandY rescale
        inside the C read loop); dsec stays on the python path."""
        if not self.cfg.use_native:
            return False
        if self.cfg.profile:
            # per-item timers need the python path (the C++ loader reads
            # whole batches inside its own threads)
            return False
        if self.ds.loader is imgnet_columns_loader:
            # the C reader parses ZIP_STORED .npz; structured .npy samples
            # stay on the python columns path
            if not self.ds.samples[0][0].endswith(".npz"):
                return False
            return native.available()
        if self.ds.loader not in (caltech_npy_loader, ncars_npy_loader):
            return False
        if self.cfg.scale_xy is not None:
            return False
        return native.available()

    def _load_batch_native(self, epoch: int, chunk) -> dict:
        """Threaded C++ load+slice+pad+extent pass (mem_tpu_torch.native), with the
        per-sample augmentation randomness still drawn host-side. The random
        stream differs from the python path (both deterministic)."""
        cfg = self.cfg
        paths = [self.ds.samples[int(i)][0] for i in chunk]
        labels = [self.ds.samples[int(i)][1] for i in chunk]
        rngs = [np.random.default_rng((cfg.seed, epoch, int(i))) for i in chunk]
        fracs = [r.random() for r in rngs]
        if self.ds.loader is imgnet_columns_loader:
            # N-ImageNet .npz: slice-first column reads + in-loop rescale;
            # deferred (on-device) scale ships the raw coords and
            # _maybe_compact packs them into the int16 wire
            events, n_valid, maxxy = native.load_batch_imgnet(
                paths, fracs, cfg.slice_max_evs,
                scale_xy=None if self._defer_scale else cfg.scale_xy,
                num_threads=max(cfg.num_workers, 1),
            )
            events_key = "events"
        elif cfg.compact_wire:
            # C threads emit the int16 [x, y, p] wire format directly
            events, n_valid, maxxy = native.load_batch_xyp(
                paths, fracs, cfg.slice_max_evs,
                num_threads=max(cfg.num_workers, 1),
            )
            events_key = "events_xyp"
        else:
            events, n_valid, maxxy = native.load_batch(
                paths, fracs, cfg.slice_max_evs,
                num_threads=max(cfg.num_workers, 1),
            )
            events_key = "events"
        B = len(paths)
        if cfg.fixed_hw is not None:
            sh = np.full((B,), cfg.fixed_hw[0], np.int32)
            sw = np.full((B,), cfg.fixed_hw[1], np.int32)
        elif cfg.sample_hw_from_data:
            # empty samples report maxxy == 0; fall back to the canvas
            # extent like _load_one's `n > 0` guard
            sw = np.where(n_valid > 0, np.minimum(maxxy[:, 0], cfg.canvas_w),
                          cfg.canvas_w).astype(np.int32)
            sh = np.where(n_valid > 0, np.minimum(maxxy[:, 1], cfg.canvas_h),
                          cfg.canvas_h).astype(np.int32)
        else:
            sh = np.full((B,), cfg.canvas_h, np.int32)
            sw = np.full((B,), cfg.canvas_w, np.int32)

        batch = {
            events_key: events,
            "n_valid": n_valid,
            "label": np.asarray(labels, np.int64),
            "sample_h": sh,
            "sample_w": sw,
            "time_flip": np.array(
                [cfg.is_train and r.random() < cfg.time_flip_prob for r in rngs]
            ),
            "x_flip": np.array(
                [cfg.is_train and r.random() < cfg.flip_x_prob for r in rngs]
            ),
            "shift_xy": np.stack([
                r.integers(-cfg.max_random_shift_evs, cfg.max_random_shift_evs + 1,
                           size=(2,)).astype(np.int32)
                if (cfg.is_train and cfg.max_random_shift_evs > 0)
                else np.zeros((2,), np.int32)
                for r in rngs
            ]),
            "aug_seed": np.stack([
                r.integers(0, 2**31 - 1, dtype=np.int64).astype(np.uint32)
                for r in rngs
            ]),
        }
        if self.mask_gen is not None:
            batch["mask"] = np.stack([self._sample_mask(r) for r in rngs])
        return batch

    def _maybe_compact(self, batch: dict) -> dict:
        if not self.cfg.compact_wire or "events" not in batch:
            return batch  # off, or the native loader already emitted xyp
        e = batch.pop("events")
        # per-column sliced stores: each converts f32->int16 directly with
        # no intermediate f32 gather copy (2x less host memory traffic than
        # a fancy-index + astype)
        xyp = np.empty(e.shape[:-1] + (3,), np.int16)
        xyp[..., 0] = e[..., 0]
        xyp[..., 1] = e[..., 1]
        xyp[..., 2] = e[..., 3]
        batch["events_xyp"] = xyp
        return batch

    def epoch(self, epoch: int) -> Iterator[dict]:
        idx = self._epoch_indices(epoch)
        b = self.cfg.batch_size
        n_batches = len(idx) // b if self.cfg.drop_last else -(-len(idx) // b)
        native_ok = self._native_eligible()
        for bi in range(n_batches):
            chunk = list(idx[bi * b : (bi + 1) * b])
            # pad the final partial batch by wrapping (reference eval pads
            # with duplicates, run_mem_pretraining.py:313-316)
            while len(chunk) < b:
                chunk.append(chunk[len(chunk) % max(len(chunk), 1)])
            if native_ok:
                try:
                    yield self._maybe_compact(self._load_batch_native(epoch, chunk))
                    continue
                except IOError:
                    pass  # corrupt file: fall through to the retrying path
            if self._pool is not None:
                items = list(self._pool.map(lambda i: self._load_one(epoch, int(i)), chunk))
            else:
                items = [self._load_one(epoch, int(i)) for i in chunk]
            yield self._maybe_compact(self._collate(items))
