"""Early SIGTERM latch (stdlib-only: safe to import before torch).

A preemption signal (what SLURM/GKE send before killing a pod) can land
while a training CLI is still importing torch, building the CUDA kernels
or loading its first batch. Until a handler is installed, the default
disposition kills the process with exit 143 and no checkpoint. Each CLI
therefore calls :func:`latch` as its FIRST import side effect, before any
heavy import; the real poll-able flag
(``mem_tpu_torch.utils.preemption.GracefulShutdown``) later adopts anything
latched here, so a setup-time SIGTERM turns into a graceful
save-checkpoint-and-exit-0 at the first epoch-loop check.

The port's own copy of mem_tpu/_signals.py.
"""
from __future__ import annotations

import signal

_pending = False
_installed = False


def _handler(signum, frame):
    global _pending
    _pending = True


def latch(signals=(signal.SIGTERM,)) -> None:
    """Install the early latch (idempotent; main thread only)."""
    global _installed
    if _installed:
        return
    for s in signals:
        try:
            signal.signal(s, _handler)
        except (ValueError, OSError):  # non-main thread / unsupported
            return
    _installed = True


def pending() -> bool:
    """True if a signal was latched before the real handler took over."""
    return _pending
