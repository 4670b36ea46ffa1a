"""Metric aggregation (reference mem/utils.py:34-207).

The port's own copy of mem_tpu/utils/metrics.py ``SmoothedValue`` /
``MetricLogger``: the reference's windowed median / average and global
average. The port runs one process, so nothing is gathered across
processes; per-step device metrics arrive as floats the caller has read
back.
"""
from __future__ import annotations

from collections import defaultdict, deque
from typing import Dict

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

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())
