"""Benchmark the full ViT-B MEM pretraining step on the card: ms per step
and samples/s for both RandAugment modes.

Port of scripts/bench_pretrain_step.py. On the card, from the repo root::

    python -m mem_tpu_torch.tools.bench_pretrain_step [B=128] [N=30000] [iters=20]
        [bf16_moments=0] [device=cuda|cpu]

For ``rand_aug_batch_ops`` on, then off, it builds
``tools.trace_pretrain``'s step (the reference's configuration), takes one
step (the setup seconds include it and the kernels' first launches), then
``iters`` steps on the one batch, timed on the host clock with one
synchronize at the end, as the reference times them; beside that the median
of the same steps' CUDA-event times, the peak memory and the card's name and
power limit. One JSON line a mode. Runs on the card unless ``device=cpu``;
exits 2 without one.
"""
from __future__ import annotations

import json
import statistics
import sys
import time

import torch

from mem_tpu_torch.tools import trace_pretrain as T
from mem_tpu_torch.tools.step_timers import gpu_name, parse_args, refuse


def bench(cfg, device, iters=20, model_kw=None, vae_kw=None) -> dict:
    """One mode: setup seconds, host-clock ms per step over ``iters``
    steps, the CUDA-event median (None on the CPU), samples/s and the
    losses."""
    cuda = torch.device(device).type == "cuda"
    t_start = time.time()
    step, _, _, _ = T.build(cfg, device, model_kw, vae_kw)
    batch = T.step_batches(cfg["batch"], cfg["preproc"], device, 1, first=0)[0][0]
    m = step(batch, 0)
    float(m["loss"])
    setup = time.time() - t_start
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    events, losses = [], []
    t0 = time.time()
    for i in range(iters):
        if cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
        losses.append(step(batch, i + 1)["loss"])
        if cuda:
            b.record()
            events.append((a, b))
    if cuda:
        torch.cuda.synchronize()
    dt = (time.time() - t0) / iters
    B = len(cfg["batch"]["n_valid"])
    return dict(batch_ops=cfg["preproc"].rand_aug_batch_ops, batch=B, setup_s=setup,
                ms_per_step=dt * 1e3, samples_per_s=B / dt,
                event_median_ms=statistics.median(a.elapsed_time(b) for a, b in events)
                if events else None,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
                losses=[float(x) for x in losses])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    kv = parse_args(argv)
    bad = refuse("bench_pretrain_step", kv)
    if bad:
        print(bad[1], file=sys.stderr)
        return bad[0]
    device = torch.device(kv.get("device", "cuda"))
    gpu = gpu_name(device)
    print(gpu, flush=True)
    B, N, iters = int(kv.get("B", 128)), int(kv.get("N", 30000)), int(kv.get("iters", 20))
    for bo in (True, False):
        cfg = T.config(bo, True, B, N, bf16_moments=bool(int(kv.get("bf16_moments", 0))))
        r = bench(cfg, device, iters)
        print(f"batch_ops={bo} setup+compile {r['setup_s']:.0f}s", flush=True)
        print(f"batch_ops={bo}: {r['ms_per_step']:.1f} ms/step -> {r['samples_per_s']:.1f} "
              f"samples/sec (host clock)"
              + (f"; CUDA-event median {r['event_median_ms']:.1f} ms" if r["event_median_ms"]
                 else ""), flush=True)
        print(json.dumps({"tool": "bench_pretrain_step", "gpu": gpu, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
