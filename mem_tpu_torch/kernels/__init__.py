"""The port's hand-written CUDA kernels: launch counts shared by the wrappers.

Each kernel wrapper (ops/voxelize_hist.py, ops/attention.py, ops/mlp.py) calls
:func:`count_launch` right where it launches its kernel, and nowhere else,
so a run can show that its main path really went through the kernels. A
CUDA graph replays its launches without calling the wrappers: the chain that
captured it (train/chain.py) adds the graph's launches with
:func:`add_launches` at every replay, and takes back what its capture counted.
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


def add_launches(counts: dict) -> None:
    """Add ``{name: launches}`` (negative to take back) to the counts."""
    with _lock:
        for name, n in counts.items():
            _counts[name] += n
            if not _counts[name]:
                del _counts[name]


def launch_counts() -> dict:
    with _lock:
        return dict(_counts)


def reset_launch_counts() -> None:
    with _lock:
        _counts.clear()
