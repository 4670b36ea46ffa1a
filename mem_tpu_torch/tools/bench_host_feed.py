"""The host -> card feed: measured loader rates, the measured copy to the
card, and the duty-cycle arithmetic against the card's own step times.

Port of scripts/bench_host_feed.py. From the repo root::

    python -m mem_tpu_torch.tools.bench_host_feed [step_ms=<ms>] [seg_step_ms=<ms>]
        [B=128] [seg_B=16] [nbatches=6] [files=256] [ni_files=192] [dsec_files=48]
        [dir=<dataset dir>] [device=cuda|cpu]
    python -m mem_tpu_torch.tools.bench_host_feed --concurrent N [dir=<dataset dir>]

1. The loaders, on the host's CPU, one process: the pretraining iterator on
   N-Caltech-like .npy files (native reader, mask pool), N-ImageNet-like
   structured .npz records (the column reader, then the compact int16 wire
   with ReshapeScaleXandY on the device), DSEC-like 180k-event windows
   (crop, slice, counting sort, compact wire, label PNGs): samples/s and
   the wire bytes of a batch.
2. The staging, on the card: the batch's copy to ``cuda`` from pageable
   memory (``tensor.to("cuda")``) and from pinned memory (the host copy
   into a pinned buffer, then ``to("cuda", non_blocking=True)``), each
   timed apart: bytes/s of each.
3. The step: ``step_ms`` (the pretraining step at ``B``, 128) and
   ``seg_step_ms`` (the seg step at ``seg_B``, 16: the reference's per-GPU
   batch) from the port's
   own readings (``tools.bench_pretrain_step``, ``tools.trace_seg``), or,
   where not passed and a card is there, measured in this call (the median
   CUDA-event ms of 5 steps after 2).

:func:`report` prints one duty-cycle line a copy path: the feed keeps up
where loader time, staging and copy together stay under the step. With
``--concurrent N``, N loader processes run side by side over one dataset
and their aggregate rate is set against one process's alone. The synthetic
sets are written under ``dir`` (the temporary directory by default), in
folders named with their file counts, and reused by a later run that asks
for the same counts. With ``device=cpu`` only the loaders run. Exits 2 without a card unless
``device=cpu``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

B = 128
N = 30000
SEG_B = 16
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _dir(base, name, files):
    """The synthetic set's folder: its size is in its name, so a set is
    reused only by a run that asks for the same number of files."""
    return os.path.join(base or tempfile.gettempdir(), f"{name}_{files}")


def measure_loader(base=None, nbatches=6, files=256, B_=B):
    from mem_tpu_torch.tools.bench_host_loader import bench, make_dataset

    tmp = _dir(base, "host_feed_ds", files)
    if not os.path.isdir(f"{tmp}/train/cls"):
        make_dataset(tmp, files)
    return bench(tmp, B=B_, workers=0, native=True, mask_pool=4096, nbatches=nbatches)


def staging_batch(B_=B):
    """The compact-wire pretraining batch (bench_host_feed.py:48-53)."""
    return {
        "events": np.zeros((B_, N, 3), np.int16),
        "n_valid": np.zeros((B_,), np.int32),
        "mask": np.zeros((B_, 196), bool),
        "label": np.zeros((B_,), np.int64),
    }


def measure_staging(reps=10, B_=B):
    """(bytes a batch, s a pageable copy to the card, s a host copy into a
    pinned buffer, s a copy from the pinned buffer to the card): each the
    mean of ``reps`` after 2 warm-up copies, a synchronize closing each."""
    import torch

    host = {k: torch.from_numpy(v) for k, v in staging_batch(B_).items()}
    nbytes = sum(t.numel() * t.element_size() for t in host.values())
    pinned = {k: torch.empty_like(t).pin_memory() for k, t in host.items()}

    def timed(fn):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps

    pageable = timed(lambda: [t.to("cuda") for t in host.values()])
    stage = timed(lambda: [p.copy_(t) for p, t in zip(pinned.values(), host.values())])
    wire = timed(lambda: [p.to("cuda", non_blocking=True) for p in pinned.values()])
    return nbytes, pageable, stage, wire


def measure_nimagenet_loader(base=None, B_=128, nbatches=4, compact=False, files=192):
    """N-ImageNet-shaped ingest (bench_host_feed.py:66-121): structured .npz
    records of 30k..120k events, the column reader, ReshapeScaleXandY on the
    x / y columns (on the host, or on the device with the compact wire),
    sliced to 30k."""
    from mem_tpu_torch.data.folder import NpyFolder, imgnet_columns_loader
    from mem_tpu_torch.data.pipeline import EventBatchIterator, PipelineConfig
    from mem_tpu_torch.tools.bench_host_loader import stream

    tmp = _dir(base, "host_feed_nimagenet", files)
    if not os.path.isdir(f"{tmp}/train/cls"):
        rng = np.random.default_rng(1)
        os.makedirs(f"{tmp}/train/cls", exist_ok=True)
        for i in range(files):
            n = int(rng.integers(30000, 120000))
            rec = np.zeros(n, dtype=[("x", "<u2"), ("y", "<u2"), ("t", "<i8"), ("p", "u1")])
            rec["x"] = rng.integers(0, 640, n)
            rec["y"] = rng.integers(0, 480, n)
            rec["t"] = np.sort(rng.integers(0, 10**6, n))
            rec["p"] = rng.integers(0, 2, n)
            np.savez(f"{tmp}/train/cls/s{i}.npz", **{k: rec[k] for k in ("x", "y", "t", "p")})
    ds = NpyFolder(f"{tmp}/train", loader=imgnet_columns_loader)
    s = 256.0 / 480.0
    cfg = PipelineConfig(
        batch_size=B_, slice_max_evs=N, is_train=True,
        max_random_shift_evs=15, sample_hw_from_data=False,
        canvas_h=256, canvas_w=342, fixed_hw=(256, 342), scale_xy=(s, s),
        masking="block", window_size=(14, 14), num_mask_patches=98,
        min_mask_patches_per_block=16, mask_pool_size=4096,
        num_workers=0, seed=0, compact_wire=compact,
    )
    gen = stream(EventBatchIterator(ds, cfg))
    for _ in range(2):   # cover the whole file set: page cache + zip tables
        b0 = next(gen)
    t0 = time.perf_counter()
    for _ in range(nbatches):
        b0 = next(gen)
    sps = nbatches * B_ / (time.perf_counter() - t0)
    return sps, sum(np.asarray(v).nbytes for v in b0.values())


def measure_dsec_loader(base=None, B_=SEG_B, nbatches=4, files=48):
    """DSEC seg ingest (bench_host_feed.py:124-158): 180k-event .npy pairs
    through SegBatchIterator (y < 440 crop, 180k slice, y presort, compact
    int16 wire, label PNG decode)."""
    from mem_tpu_torch.data.seg_pipeline import SegBatchIterator, SegPipelineConfig

    tmp = _dir(base, "host_feed_dsec", files)
    if not os.path.isdir(f"{tmp}/imgs"):
        from PIL import Image

        rng = np.random.default_rng(2)
        os.makedirs(f"{tmp}/imgs", exist_ok=True)
        os.makedirs(f"{tmp}/anns", exist_ok=True)
        for i in range(files):
            n = int(rng.integers(180000, 260000))
            ev = np.zeros((n, 4), np.float32)
            ev[:, 0] = rng.integers(0, 640, n)
            ev[:, 1] = rng.integers(0, 480, n)
            ev[:, 3] = rng.integers(0, 2, n)
            np.save(f"{tmp}/imgs/s{i}.npy", ev)
            Image.fromarray(rng.integers(0, 11, (440, 640)).astype(np.uint8)).save(
                f"{tmp}/anns/s{i}.png")
    n_pairs = len([f for f in os.listdir(f"{tmp}/imgs") if f.endswith(".npy")])
    pairs = [(f"{tmp}/imgs/s{i}.npy", f"{tmp}/anns/s{i}.png") for i in range(n_pairs)]
    gen = SegBatchIterator(pairs, SegPipelineConfig(batch_size=B_, num_workers=0,
                                                    seed=0)).batches(start_iter=0)
    b0 = next(gen)
    t0 = time.perf_counter()
    for _ in range(nbatches):
        b0 = next(gen)
    sps = nbatches * B_ / (time.perf_counter() - t0)
    return sps, sum(np.asarray(v).nbytes for v in b0.values())


def report(title, loader_sps, nbytes, step_ms, B_, wires, quiet=False):
    """The reference's duty-cycle arithmetic (bench_host_feed.py:161-183)
    for each copy path of ``wires``: (name, copy bytes/s, staging bytes/s or
    None where the copy stages nothing first). Per batch: loader time B /
    loader rate, staging nbytes / staging rate, copy nbytes / copy rate; the
    pipelined rate is B over the longest of loader, staging + copy and
    step, and the duty the share of the step that staging + copy take.
    Returns one dict a path; ``step_ms`` None leaves the step out."""
    loader_s = B_ / loader_sps
    step_s = step_ms / 1e3 if step_ms else None
    if not quiet:
        print(f"\n== {title}: B={B_}, wire {nbytes/1e6:.1f} MB/batch, " + (
            f"card step {step_ms:.1f} ms ({B_/step_s:.0f} samples/s)" if step_s else
            "card step not measured"))
        print(f"loader (1 process): {loader_sps:.0f} samples/s -> {loader_s*1e3:.1f} ms/batch"
              + (f" ({loader_sps*step_s/B_:.2f}x the card's demand per process)" if step_s
                 else ""))
    rows = []
    for name, rate_bps, stage_bps in wires:
        stage_s = nbytes / stage_bps if stage_bps else 0.0
        wire_s = nbytes / rate_bps
        total = max(loader_s, stage_s + wire_s, step_s or 0.0)
        bound = ("device" if total == step_s else
                 "loader" if total == loader_s else "wire")
        row = dict(path=name, stage_ms=stage_s * 1e3, wire_ms=wire_s * 1e3,
                   pipelined_samples_per_s=B_ / total, bound=bound,
                   duty=(stage_s + wire_s) / step_s if step_s else None)
        rows.append(row)
        if not quiet:
            print(f"{name:28s} wire {wire_s*1e3:7.1f} ms/batch | "
                  f"pipelined {B_ / total:6.0f} samples/s ({bound}-bound) | "
                  + (f"duty {100*row['duty']:5.1f}% of step" if step_s else "no step"))
    return rows


def _worker_rate(which: str, base=None) -> float:
    if which == "caltech":
        return measure_loader(base)
    if which == "nimagenet_compact":
        return measure_nimagenet_loader(base, compact=True)[0]
    if which == "dsec":
        return measure_dsec_loader(base)[0]
    raise SystemExit(f"unknown worker {which}")


def measure_concurrent(n_procs: int, which: str = "nimagenet_compact", base=None,
                       chip_sps=None):
    """N loader processes side by side over one dataset (shared page cache
    and code paths); their aggregate rate against one process alone:
    ``efficiency = aggregate / solo``. With ``chip_sps`` (the card's demand,
    samples/s) the processes one card needs: chip_sps / (solo x
    efficiency)."""
    solo = _worker_rate(which, base)
    cmd = [sys.executable, "-m", "mem_tpu_torch.tools.bench_host_feed", "--worker", which]
    if base:
        cmd.append(f"dir={base}")
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, cwd=REPO,
                              env={**os.environ, "PYTHONPATH": REPO})
             for _ in range(n_procs)]
    rates = []
    for p in procs:
        out, _ = p.communicate(timeout=1200)
        rates.append(json.loads(out.strip().splitlines()[-1])["sps"])
    agg = sum(rates)
    eff = agg / solo
    print(f"\n== concurrent loaders ({which}): solo {solo:.0f} samples/s | {n_procs} procs "
          f"side by side: {' + '.join(f'{r:.0f}' for r in rates)} = {agg:.0f} aggregate | "
          f"efficiency {eff:.2f}x")
    if chip_sps:
        print(f"-> one card takes {chip_sps:.0f} samples/s: {chip_sps / (solo * eff):.1f} "
              f"loader processes at the measured rate x efficiency")
    return solo, rates, eff


def measure_steps(B_=B, seg_B=SEG_B):
    """(pretraining step ms at ``B_``, seg step ms at ``seg_B``) on the card: the
    median CUDA-event ms of 5 steps after 2 of ``tools.trace_pretrain``'s and
    ``tools.trace_seg``'s steps."""
    import torch

    from mem_tpu_torch.tools import trace_pretrain, trace_seg
    from mem_tpu_torch.tools.step_timers import time_steps

    dev = torch.device("cuda")
    cfg = trace_pretrain.config(B=B_)
    step = trace_pretrain.build(cfg, dev)[0]
    batch = trace_pretrain.step_batches(cfg["batch"], cfg["preproc"], dev, 1, first=0)[0][0]
    pt = time_steps(lambda i: step(batch, i), 7, warm=2)["ms"]
    del step, batch
    torch.cuda.empty_cache()
    cfg = trace_seg.config(seg_B)
    step = trace_seg.build(cfg, dev)[0]
    batch = trace_seg.device_batch(cfg, dev)
    seg = time_steps(lambda i: step(batch, i), 7, warm=2)["ms"]
    del step, batch
    torch.cuda.empty_cache()
    return pt, seg


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    flags = [a for a in argv if "=" not in a]
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    base = kv.get("dir")
    if "--worker" in flags:
        print(json.dumps({"sps": _worker_rate(flags[flags.index("--worker") + 1], base)}))
        return 0
    import torch

    cpu_only = kv.get("device", "cuda") == "cpu"
    if not cpu_only and not torch.cuda.is_available():
        print("bench_host_feed: no CUDA device is available (pass device=cpu for the "
              "loaders alone)", file=sys.stderr)
        return 2
    from mem_tpu_torch.tools.bench_host_loader import cores
    from mem_tpu_torch.tools.step_timers import gpu_name

    print(gpu_name("cpu" if cpu_only else "cuda"), f"| host cores: {cores()}", flush=True)
    b, sb = int(kv.get("B", B)), int(kv.get("seg_B", SEG_B))
    step_ms = float(kv["step_ms"]) if "step_ms" in kv else None
    seg_ms = float(kv["seg_step_ms"]) if "seg_step_ms" in kv else None
    if not cpu_only and (step_ms is None or seg_ms is None):
        pt, seg = measure_steps(b, sb)
        step_ms, seg_ms = step_ms or pt, seg_ms or seg
        print(f"card steps measured in this call: pretraining B={b} {pt:.1f} ms, "
              f"seg B={sb} {seg:.1f} ms", flush=True)
    if "--concurrent" in flags:
        n = int(flags[flags.index("--concurrent") + 1])
        for which in ("nimagenet_compact", "dsec"):
            measure_concurrent(n, which, base, (sb / (seg_ms / 1e3) if which == "dsec"
                                                else b / (step_ms / 1e3)) if step_ms else None)
        return 0
    nb, files = int(kv.get("nbatches", 6)), int(kv.get("files", 256))
    wires, out = [], {}
    if not cpu_only:
        nbytes, pageable, stage, wire = measure_staging(B_=b)
        wires = [("pageable copy (measured)", nbytes / pageable, None),
                 ("pinned copy (measured)", nbytes / wire, nbytes / stage)]
        out["staging"] = dict(bytes=nbytes, pageable_gb_s=nbytes / pageable / 1e9,
                              pin_stage_gb_s=nbytes / stage / 1e9,
                              pinned_gb_s=nbytes / wire / 1e9)
        print(f"staging: pageable -> card {nbytes / pageable / 1e9:.2f} GB/s; host -> pinned "
              f"{nbytes / stage / 1e9:.2f} GB/s, pinned -> card {nbytes / wire / 1e9:.2f} GB/s")
    rows = [("N-Caltech101 pretrain (native, mask pool)", measure_loader(base, nb, files, b),
             sum(a.nbytes for a in staging_batch(b).values()), step_ms, b)]
    ni_files, dsec_files = int(kv.get("ni_files", 192)), int(kv.get("dsec_files", 48))
    ni = measure_nimagenet_loader(base, b, nbatches=max(1, nb - 2), files=ni_files)
    rows.append(("N-ImageNet pretrain (.npz structured + ReshapeScaleXandY, native column "
                 "reader)", *ni, step_ms, b))
    nc = measure_nimagenet_loader(base, b, nbatches=max(1, nb - 2), compact=True,
                                  files=ni_files)
    rows.append(("N-ImageNet pretrain (compact int16 wire, on-device ReshapeScaleXandY)",
                 *nc, step_ms, b))
    ds = measure_dsec_loader(base, sb, nbatches=max(1, nb - 2), files=dsec_files)
    rows.append(("DSEC seg (180k evs, native crop+slice+counting-sort, compact wire)", *ds,
                 seg_ms, sb))
    out["rows"] = [dict(title=t, loader_samples_per_s=sps, bytes=nbytes, step_ms=ms, batch=b,
                        paths=report(t, sps, nbytes, ms, b, wires))
                   for t, sps, nbytes, ms, b in rows]
    print(json.dumps({"tool": "bench_host_feed", "cores": cores(), **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
