"""Graceful-preemption handling for the training loops.

The port's own copy of mem_tpu/utils/preemption.py. A
SIGTERM/SIGINT (what SLURM/GKE/Borg send before killing a pod) sets a flag;
the loop finishes the step in flight, saves a resumable checkpoint, and
exits 0, so the requeued job continues from the interrupted epoch instead
of the last periodic save.

Usage:
    stopper = GracefulShutdown()
    for epoch in ...:
        for step, batch in ...:
            ...
            if stopper.requested:
                break
        if stopper.requested:
            save_checkpoint(...)   # tagged with the current epoch
            print("preempted: checkpoint saved; exiting for requeue")
            return
"""
from __future__ import annotations

import signal

from mem_tpu_torch import _signals

# Exit code for the RSS-watchdog recycle path: the loop saved a resumable
# checkpoint and wants to be RELAUNCHED (scripts/run_resilient.sh loops
# while it sees this code). Distinct from 0 (done / graceful preemption)
# and 1 (error).
RESTART_EXIT_CODE = 3


def rss_gb() -> float:
    """Resident set size of this process in GB (psutil)."""
    import psutil

    return psutil.Process().memory_info().rss / 1e9


def validate_rss_flag(limit_gb: float) -> None:
    """Fail fast at startup when --rss_restart_gb is enabled but psutil is
    unavailable: otherwise the ModuleNotFoundError would only surface at
    the first epoch boundary, hours into a run, with a non-RESTART exit
    code that makes run_resilient.sh give up."""
    if limit_gb and limit_gb > 0:
        try:
            rss_gb()
        except ImportError as e:
            raise SystemExit(
                f"--rss_restart_gb {limit_gb} needs psutil, which failed to "
                f"import: {e}") from e


def rss_recycle_due(limit_gb: float) -> bool:
    """True when the memory-recycle watchdog should fire: the host RSS above
    ``limit_gb`` (0 = off). Every process of a multi-process run agrees (the
    max over the processes, preemption.py:55-86): a process that tripped
    alone would enter the checkpoint save while its peers wait in the next
    epoch's collectives."""
    if not (limit_gb and limit_gb > 0):
        return False
    mine = rss_gb()
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        import torch

        t = torch.tensor([mine], dtype=torch.float64)
        if dist.get_backend() == "nccl":
            t = t.cuda()
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        mine = float(t.item())
    return mine > limit_gb


class GracefulShutdown:
    """Latches SIGTERM (and optionally SIGINT) into a poll-able flag.

    Adopts any signal already latched by :mod:`mem_tpu_torch._signals` (the
    stdlib-only early latch the CLIs install before importing torch), so a
    SIGTERM that lands during setup is not lost.
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self.requested = _signals.pending()
        self._previous = {}
        for s in signals:
            try:
                self._previous[s] = signal.signal(s, self._handler)
            except (ValueError, OSError):  # non-main thread / unsupported
                pass

    def _handler(self, signum, frame):
        self.requested = True

    def restore(self):
        for s, h in self._previous.items():
            signal.signal(s, h)
