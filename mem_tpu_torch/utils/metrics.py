"""Metric aggregation and the logging sinks (reference mem/utils.py:34-207).

The port's own copy of mem_tpu/utils/metrics.py ``SmoothedValue`` /
``MetricLogger`` (the reference's windowed median / average and global
average), ``TensorboardLogger`` and ``maybe_wandb``. Per-step device
metrics arrive as floats the caller has read back; in a multi-process run
``synchronize_between_processes`` sums the global counts and totals over the
processes (metrics.py:36-45), and only rank 0 writes the sinks. Both sinks fall back as the
reference's do when their package is missing: the TensorBoard logger
writes nothing, ``maybe_wandb`` returns None.
"""
from __future__ import annotations

from collections import defaultdict, deque
from typing import Dict, Optional

import numpy as np


class SmoothedValue:
    """Track a series with a smoothing window (utils.py:34-99)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self, group=None):
        """Sum the count and total over the processes (f64, one all-reduce);
        the window stays this process's."""
        import torch
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()) \
                or dist.get_world_size(group) == 1:
            return
        t = torch.tensor([self.count, self.total], dtype=torch.float64)
        if dist.get_backend(group) == "nccl":
            t = t.cuda()
        dist.all_reduce(t, group=group)
        self.count, self.total = int(t[0].item()), float(t[1].item())

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value,
        )


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, n: int = 1, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v), n=n)

    def add_meter(self, name: str, meter: SmoothedValue):
        self.meters[name] = meter

    def synchronize_between_processes(self, group=None):
        for name in sorted(self.meters):     # the same order on every process
            self.meters[name].synchronize_between_processes(group)

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())


class TensorboardLogger:
    """Thin SummaryWriter wrapper (utils.py:186-207); a no-op when
    ``torch.utils.tensorboard`` cannot be imported."""

    def __init__(self, log_dir: str):
        self.step = 0
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.writer = SummaryWriter(log_dir)
        except Exception:
            self.writer = None

    def set_step(self, step: Optional[int] = None):
        self.step = step if step is not None else self.step + 1

    def update(self, head: str = "scalar", step: Optional[int] = None, **kwargs):
        if self.writer is None:
            return
        for k, v in kwargs.items():
            if v is None:
                continue
            self.writer.add_scalar(f"{head}/{k}", float(v), self.step if step is None else step)

    def flush(self):
        if self.writer is not None:
            self.writer.flush()


def maybe_wandb(enabled: bool, **init_kwargs):
    """The ``wandb`` module after ``wandb.init(**init_kwargs)``, or None when
    ``enabled`` is false or wandb is missing or fails to start."""
    if not enabled:
        return None
    try:
        import wandb

        wandb.init(**init_kwargs)
        return wandb
    except Exception:
        return None
