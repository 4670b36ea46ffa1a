"""Profiling and throughput counters, port of mem_tpu/utils/profiling.py.

- ``trace(log_dir)``: a ``torch.profiler`` trace of the block (CUDA activity
  where the card is available), written into ``log_dir`` as a Chrome trace
  file (``<host>_<pid>.<time>.pt.trace.json``, what TensorBoard's profiler
  plugin and Perfetto read); a no-op without a directory. The reference
  wraps ``jax.profiler.trace`` the same way.
- ``StepTimer``: samples/s with the first ``warmup`` steps excluded.
- ``device_memory_stats``: each CUDA device's bytes in use, peak and limit
  under the reference's three keys.
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """A torch.profiler trace of the block into ``log_dir``, or nothing
    when ``log_dir`` is empty. The caller synchronizes the device before the
    block ends when it wants the block's kernels in the trace."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class StepTimer:
    """samples/s (and per device) with the first ``warmup`` steps excluded,
    so warm-up and kernel builds never enter the rate."""

    def __init__(self, batch_size: int, warmup: int = 2):
        self.batch_size = batch_size
        self.warmup = warmup
        self.steps = 0
        self.t0 = None

    def step(self) -> Optional[float]:
        """Call once per optimizer step; returns the samples/s since the
        end of the warm-up, or None while warming up."""
        self.steps += 1
        if self.steps == self.warmup:
            self.t0 = time.perf_counter()
            return None
        if self.steps < self.warmup or self.t0 is None:
            return None
        elapsed = time.perf_counter() - self.t0
        done = self.steps - self.warmup
        return done * self.batch_size / max(elapsed, 1e-9)

    def per_chip(self, rate: Optional[float]) -> Optional[float]:
        """``rate`` over the visible CUDA devices (one without CUDA)."""
        return None if rate is None else rate / max(torch.cuda.device_count(), 1)


def device_memory_stats() -> dict:
    """{"cuda:i": {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}} for
    each visible CUDA device (the caching allocator's current and peak
    allocations, the device's total memory); {} without CUDA."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.mem_get_info(i)[1],
        }
    return out
