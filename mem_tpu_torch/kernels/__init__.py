"""The port's hand-written CUDA kernels: launch counts shared by the wrappers.

Each kernel wrapper (ops/voxelize_hist.py, ops/attention.py, ops/mlp.py) calls
:func:`count_launch` right where it launches its kernel, and nowhere else,
so a run can show that its main path really went through the kernels.
Building and binding live in :mod:`mem_tpu_torch.kernels.build`.
"""
from __future__ import annotations

import collections
import threading

_lock = threading.Lock()
_counts: collections.Counter = collections.Counter()


def count_launch(name: str) -> None:
    with _lock:
        _counts[name] += 1


def launch_counts() -> dict:
    with _lock:
        return dict(_counts)


def reset_launch_counts() -> None:
    with _lock:
        _counts.clear()
