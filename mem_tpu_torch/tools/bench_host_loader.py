"""The host's event ingest rate: ``EventBatchIterator`` samples/s for the
B=128 pretraining configuration (BEiT block masks included).

Port of scripts/bench_host_loader.py. On any host (no card needed), from the
repo root::

    python -m mem_tpu_torch.tools.bench_host_loader [files=256] [nbatches=6] [B=128]
        [pool=4096]

It writes a synthetic N-Caltech-like set (``files`` .npy files of 15,000 to
60,000 events from ``np.random.default_rng(0)``) into a temporary directory,
prints the cost of each part of one B-sample batch (npy load, slice + pad,
mask generation), then samples/s at batch B over ``{native on/off} x
{workers 0, 2, 4, 8} x {mask_pool 0, pool}``, and the host's core count. The rates are the host
CPU's, not the card's.
"""
from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np


def make_dataset(root, n_files=256, n_events=30000):
    """bench_host_loader.py:23-33, draw for draw."""
    rng = np.random.default_rng(0)
    os.makedirs(f"{root}/train/cls", exist_ok=True)
    for i in range(n_files):
        n = int(rng.integers(n_events // 2, n_events * 2))
        ev = np.zeros((n, 4))
        ev[:, 0] = rng.integers(0, 240, n)
        ev[:, 1] = rng.integers(0, 180, n)
        ev[:, 2] = np.sort(rng.integers(0, 10**6, n))
        ev[:, 3] = rng.choice([-1.0, 1.0], n)
        np.save(f"{root}/train/cls/s{i}.npy", ev)


def stream(it):
    """The iterator's batches, epoch after epoch."""
    e = 0
    while True:
        yield from it.epoch(e)
        e += 1


def bench(root, B=128, workers=4, native=True, mask_pool=0, nbatches=6):
    """Samples/s of the pretraining iterator over ``nbatches`` batches
    after one warm-up batch."""
    from mem_tpu_torch.data.folder import NpyFolder, caltech_npy_loader
    from mem_tpu_torch.data.pipeline import EventBatchIterator, PipelineConfig

    ds = NpyFolder(f"{root}/train", loader=caltech_npy_loader)
    cfg = PipelineConfig(
        batch_size=B, slice_max_evs=30000, is_train=True,
        max_random_shift_evs=15, canvas_h=256, canvas_w=256,
        masking="block", window_size=(14, 14), num_mask_patches=98,
        min_mask_patches_per_block=16, mask_pool_size=mask_pool,
        num_workers=workers, use_native=native, seed=0,
    )
    gen = stream(EventBatchIterator(ds, cfg))
    next(gen)  # warm (thread pool spin-up, file cache)
    t0 = time.perf_counter()
    n = 0
    for _ in range(nbatches):
        next(gen)
        n += B
    return n / (time.perf_counter() - t0)


def components(root, B=128):
    """Seconds of each part of one B-sample batch: npy load, slice + pad,
    block mask generation."""
    from mem_tpu_torch.data.folder import NpyFolder, caltech_npy_loader
    from mem_tpu_torch.ops.masking import BlockMaskingGenerator

    ds = NpyFolder(f"{root}/train", loader=caltech_npy_loader)
    rng = np.random.default_rng(0)

    t0 = time.perf_counter()
    evs = [ds[i % len(ds)][0] for i in range(B)]
    t_load = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = np.zeros((B, 30000, 4), np.float32)
    for i, e in enumerate(evs):
        n = min(len(e), 30000)
        out[i, :n] = e[:n]
    t_pad = time.perf_counter() - t0

    gen = BlockMaskingGenerator((14, 14), 98, min_num_patches=16)
    t0 = time.perf_counter()
    for _ in range(B):
        gen(rng)
    t_mask = time.perf_counter() - t0
    return t_load, t_pad, t_mask


def cores() -> int:
    """The cores this process may run on."""
    return len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    kv = dict(a.split("=", 1) for a in argv)
    n_files, nbatches = int(kv.get("files", 256)), int(kv.get("nbatches", 6))
    B, pool_size = int(kv.get("B", 128)), int(kv.get("pool", 4096))
    with tempfile.TemporaryDirectory(prefix="loaderbench_") as root:
        print(f"generating dataset ({n_files} files)...; host cores: {cores()}", flush=True)
        make_dataset(root, n_files)
        tl, tp, tm = components(root, B)
        print(f"components per {B}-sample batch: npy load {tl*1e3:.0f} ms, "
              f"slice+pad {tp*1e3:.0f} ms, mask gen {tm*1e3:.0f} ms", flush=True)
        for native in (True, False):
            for workers in (0, 2, 4, 8):
                for pool in (0, pool_size):
                    try:
                        r = bench(root, B, workers=workers, native=native, mask_pool=pool,
                                  nbatches=nbatches)
                        print(f"native={native} workers={workers} "
                              f"mask_pool={pool}: {r:.0f} samples/s", flush=True)
                    except Exception as e:
                        print(f"native={native} workers={workers} mask_pool={pool}: "
                              f"FAILED {type(e).__name__}: {e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
