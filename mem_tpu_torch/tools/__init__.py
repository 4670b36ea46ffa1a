"""Command-line tools of the port that are not part of a model path: the
experiment kernels' entry points (``exp_voxelize``, ``exp_attn_bwd``,
``exp_voxelize2``), the A/B helper of the flat attention kernels
(``ab_flat_attention``), and the measuring tools (``trace_*``, ``bench_*``)
on the step timers and profilers of ``step_timers``.

This module holds what they and chip_smoke.py measure with: the CUDA-event
timer, the H100's published peaks and the bounds reckoned from them."""
from __future__ import annotations

import statistics

# the card's published peaks (H100 SXM data sheet): the bounds are reckoned from them
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12   # outside the tensor cores: the histograms' integer adds


def time_ms(fn, runs: int = 30, warmup: int = 5) -> float:
    """Median of ``runs`` per-call CUDA-event times (ms) after ``warmup``
    calls of ``fn``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, fragments, n: int = 20):
    """Device ms per call of ``fn`` over ``n`` calls after 3 warm-up calls,
    from torch.profiler: for each kernel whose name holds one of
    ``fragments`` (each launched once a call) its mean time per recorded
    launch (a trace can lose records), summed; None where none was
    recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for frag in fragments:
        evs = [e for e in prof.key_averages() if frag in e.key]
        launches = sum(e.count for e in evs)
        if launches:
            total += sum(e.self_device_time_total for e in evs) / 1e3 / launches
    return total or None


def bound(nbytes, ops, peak_ops):
    """(ms, "bytes" or "operations"): the least time the card could take, the
    larger of the bytes the function must move (each input read once, each
    output written once) over the memory rate and its operations over the
    peak rate for their type."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hist_bound(B, N, H, W, arrays=2):
    """K1 / K4, X1 and X2: col and ys read (int32; X1a reads ``arrays`` = 4:
    xs, ys, wpos, wneg), the (B, H, 2W) planes (int32 or f32; X2b / X2c: H =
    the n_tiles * TH rows they write) written; one add per event."""
    return bound(arrays * B * N * 4 + B * H * 2 * W * 4, B * N, PEAK_F32_FLOPS)


def attention_fwd_bound(B, N, H, D, itemsize=2):
    """K2f / K3f: q, k, v read and o written, the f32 bias read once; two
    products of 2 N^2 D operations per (sample, head)."""
    return bound(4 * B * N * H * D * itemsize + H * N * N * 4, 4 * B * H * N * N * D,
                 PEAK_BF16_FLOPS)


def attention_bwd_work(B, N, H, D, itemsize=2):
    """(bytes, operations) of the attention backward (K2b, K3b, X3): q, k, v,
    do and the bias read, dq, dk, dv and db written; five products of
    2 N^2 D operations per (sample, head)."""
    return 7 * B * N * H * D * itemsize + 2 * H * N * N * 4, 10 * B * H * N * N * D


def attention_bwd_bound(B, N, H, D, itemsize=2):
    """The bound of ``attention_bwd_work`` at the bf16 peak."""
    return bound(*attention_bwd_work(B, N, H, D, itemsize), PEAK_BF16_FLOPS)
