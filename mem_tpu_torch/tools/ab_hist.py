#!/usr/bin/env python3
"""Times of the event-histogram kernels K1 and K4 and of voxelize_fused for
the mem_tpu_torch tree in the current directory: one leg of an A/B
comparison of two trees on one card.

csrc/voxelize_hist.cuh holds the histogram body both kernels launch
(csrc/voxelize_hist.cu for K1, voxelize_hist_sorted.cu for K4). After a
change to them, unpack the parent's package into a git-ignored directory
and run both trees in turns inside one call on the card, since two calls
may land on two cards:

    git archive <parent> mem_tpu_torch | tar -x -C _chipcheck/parent
    r=$(pwd)
    for t in parent change change parent; do
      if [ $t = parent ]; then d=_chipcheck/parent; else d=.; fi
      (cd $d && PYTHONPATH=. python3 $r/mem_tpu_torch/tools/ab_hist.py $t)
    done

Each leg builds the tree's kernels, prints the ptxas lines of the
histogram kernels, then times, through entry points that every tree since
the port's third slice has, on seeded synthetic events:

- K1 planes (``hist_planes_cols``) at (8, 30,000) and (64, 30,000) events
  on the 256x256 N-Caltech101 canvas;
- K4 planes (``hist_planes_cols_sorted``) at (8, 180,000) y-sorted events on
  the 440x640 DSEC canvas, presorted and not, and K1 on the same events;
  K4 presorted and K1 at B = 1 and 16 as well;
- ``voxelize_fused`` as serving (B = 8 and 64, 256x256) and seg (B = 8,
  440x640, y_sorted) call it: the whole call, coordinate arithmetic included.

Per case: the median of three medians of 20 CUDA-event timings of one call
("events ms": the wrapper's host time included) and the device time per call
of every kernel it launches, from torch.profiler ("device ms"), with the
number of kernels a call launches (each kernel's mean time per recorded
launch times its launches a call: the trace can lose records).

With the word ``k1`` as a second argument a leg times K1 planes at (8,
30,000) alone and prints no ptxas lines: a short leg, for many legs in one
call, where the wrappers' host time is to be told from noise (12 legs of
each tree):

    for i in $(seq 6); do for t in parent change change parent; do
      if [ $t = parent ]; then d=_chipcheck/parent; else d=.; fi
      (cd $d && PYTHONPATH=. python3 $r/mem_tpu_torch/tools/ab_hist.py $t k1)
    done; done
"""
import re
import statistics
import sys

import numpy as np
import torch

from mem_tpu_torch.kernels import build
from mem_tpu_torch.ops import voxelize as V
from mem_tpu_torch.ops import voxelize_hist as vh
from mem_tpu_torch.tools import time_ms

RUNS, WARMUP = 20, 5
CLS_N, CLS_HW = 30_000, (256, 256)
SEG_N, SEG_HW = 180_000, (440, 640)


def cls_events(rng, B, n=CLS_N):
    """(B, n, 4) f32 N-Caltech101-like streams: x < 240, y < 180, 70 % of the
    events on a blob, sorted t, p = +-1."""
    ev = np.zeros((B, n, 4), np.float32)
    for b in range(B):
        w, h = rng.integers(160, 241), rng.integers(120, 181)
        k = int(0.7 * n)
        cx, cy = rng.uniform(0.3, 0.7) * w, rng.uniform(0.3, 0.7) * h
        x = np.concatenate([np.clip(rng.normal(cx, w / 8, k), 0, w - 1), rng.uniform(0, w, n - k)])
        y = np.concatenate([np.clip(rng.normal(cy, h / 8, k), 0, h - 1), rng.uniform(0, h, n - k)])
        perm = rng.permutation(n)
        ev[b, :, 0], ev[b, :, 1] = np.floor(x[perm]), np.floor(y[perm])
        ev[b, :, 2] = np.sort(rng.integers(0, 300_000, n))
        ev[b, :, 3] = rng.choice([-1.0, 1.0], n)
    return ev


def seg_events(rng, B, n=SEG_N):
    """(B, n, 4) f32 DSEC-like windows sorted by y (the seg pipeline's host
    presort): denser towards the bottom of the 440x640 canvas (the road),
    a few hot columns, p = +-1."""
    H, W = SEG_HW
    ev = np.zeros((B, n, 4), np.float32)
    for b in range(B):
        y = np.floor(H * np.sqrt(rng.uniform(0, 1, n)))
        x = np.where(rng.uniform(0, 1, n) < 0.1, rng.integers(0, 8, n) * 80,
                     np.floor(rng.uniform(0, W, n)))
        order = np.argsort(y, kind="stable")
        ev[b, :, 0], ev[b, :, 1] = x[order], y[order]
        ev[b, :, 2] = np.arange(n)
        ev[b, :, 3] = rng.choice([-1.0, 1.0], n)
    return ev


def packed(ev, H, W):
    """pack_cols of an event batch on the card."""
    t = torch.from_numpy(ev).cuda()
    pos = (t[..., 3] == 1).float()
    col, ys = vh.pack_cols(t[..., 0].int(), t[..., 1].int(), pos, 1.0 - pos, H, W)
    return col.contiguous(), ys.contiguous()


def short(key):
    """A profiler key's kernel name, without its namespaces and arguments."""
    m = re.search(r"(\w+)(<[^<>]*>)?\(", key)
    return (m.group(1) + (m.group(2) or "")) if m else key[:40]


# the one histogram kernel a call of every case launches once, in either
# tree: the change's body, the parent's K1 and K4
ANCHORS = ("hist_band_kernel", "hist_planes_cols_kernel", "band_hist_kernel")


def device_ms(fn, n=20, parts=None):
    """(device ms per call of every kernel ``fn`` launches, kernels a call),
    from torch.profiler over ``n`` calls; ``parts``, a dict, receives the
    device ms per call of each kernel. The trace can lose records, so each
    kernel counts with its mean time per launch recorded, times its launches
    a call: its recorded launches over those of the call's histogram kernel
    (ANCHORS), rounded; a profile with none of them is taken again, up to
    three times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        calls = sum(e.count for e in evs if any(a in e.key for a in ANCHORS))
        if calls:
            break
    if not calls:
        return None, None
    per_call = {}
    for e in evs:
        k = max(1, round(e.count / calls))
        per_call[short(e.key)] = per_call.get(short(e.key), 0) + \
            e.self_device_time_total / e.count * k / 1e3
        if parts is not None:
            parts[short(e.key)] = round(per_call[short(e.key)], 4)
    launches = sum(max(1, round(e.count / calls)) for e in evs)
    return round(sum(per_call.values()), 4), launches


def report(tag, name, fn):
    ms = statistics.median(time_ms(fn, RUNS, WARMUP) for _ in range(3))
    parts = {}
    dev, kernels = device_ms(fn, parts=parts)
    top = dict(sorted(parts.items(), key=lambda kv: -kv[1])[:4])
    print(tag, name, "events ms", round(ms, 4), "device ms", dev, "kernels", kernels, top,
          flush=True)


def main(tag: str, k1_only: bool) -> None:
    build.library()
    rng = np.random.default_rng(0)
    cls = {B: cls_events(rng, B) for B in (8, 64)}
    if k1_only:
        col, ys = packed(cls[8], *CLS_HW)
        report(tag, "K1 planes B=8 256x256", lambda: vh.hist_planes_cols(col, ys, *CLS_HW))
        return
    kernel = None
    for line in build.build_log().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = m.group(1)
        if "registers" in line and kernel and ("hist" in kernel or "chunk_bounds" in kernel):
            print(tag, kernel[-48:], "|", line.strip().replace("ptxas info    : ", "")[:72],
                  flush=True)
    seg = seg_events(rng, 8)
    for B in (8, 64):
        col, ys = packed(cls[B], *CLS_HW)
        report(tag, f"K1 planes B={B} 256x256", lambda: vh.hist_planes_cols(col, ys, *CLS_HW))
    col, ys = packed(seg, *SEG_HW)
    report(tag, "K4 presorted B=8 440x640",
           lambda: vh.hist_planes_cols_sorted(col, ys, *SEG_HW, presorted=True))
    report(tag, "K4 unsorted B=8 440x640",
           lambda: vh.hist_planes_cols_sorted(col, ys, *SEG_HW, presorted=False))
    report(tag, "K1 planes B=8 440x640 (the K4 events)",
           lambda: vh.hist_planes_cols(col, ys, *SEG_HW))
    for B in (1, 16):   # K4 against K1 at more batch sizes, on sorted events
        c, y = packed(seg_events(rng, B), *SEG_HW)
        report(tag, f"K4 presorted B={B} 440x640",
               lambda: vh.hist_planes_cols_sorted(c, y, *SEG_HW, presorted=True))
        report(tag, f"K1 planes B={B} 440x640 (the K4 events)",
               lambda: vh.hist_planes_cols(c, y, *SEG_HW))
    with torch.inference_mode():
        for B in (8, 64):
            ev = torch.from_numpy(cls[B]).cuda()
            nv = torch.full((B,), CLS_N, dtype=torch.int32, device="cuda")
            report(tag, f"voxelize_fused serving B={B} 256x256",
                   lambda: V.voxelize_fused(ev, nv, *CLS_HW))
        ev = torch.from_numpy(seg).cuda()
        nv = torch.full((8,), SEG_N, dtype=torch.int32, device="cuda")
        report(tag, "voxelize_fused seg B=8 440x640",
               lambda: V.voxelize_fused(ev, nv, *SEG_HW, y_sorted=True))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree",
         len(sys.argv) > 2 and sys.argv[2] == "k1")
