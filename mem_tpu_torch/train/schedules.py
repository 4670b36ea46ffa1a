"""Step-resolution schedules, port of mem_tpu/train/schedules.py
``cosine_scheduler`` (mem/utils.py:395-412): linear warmup (``warmup_steps``
overrides ``warmup_epochs``), then cosine from base to final over the
remaining steps, as a numpy array with one value per step."""
from __future__ import annotations

import math

import numpy as np


def cosine_scheduler(base_value: float, final_value: float, epochs: int, niter_per_ep: int,
                     warmup_epochs: int = 0, start_warmup_value: float = 0.0,
                     warmup_steps: int = -1) -> np.ndarray:
    warmup_schedule = np.array([])
    warmup_iters = warmup_epochs * niter_per_ep
    if warmup_steps > 0:
        warmup_iters = warmup_steps
    if warmup_iters > 0:
        warmup_schedule = np.linspace(start_warmup_value, base_value, warmup_iters)
    iters = np.arange(epochs * niter_per_ep - warmup_iters)
    schedule = np.array([
        final_value + 0.5 * (base_value - final_value) * (1 + math.cos(math.pi * i / len(iters)))
        for i in iters])
    schedule = np.concatenate((warmup_schedule, schedule))
    assert len(schedule) == epochs * niter_per_ep
    return schedule


def at(schedule: np.ndarray, step: int) -> float:
    """The schedule's value at ``step``, clamped at the last step (the
    reference's ``as_schedule_fn``)."""
    return float(schedule[min(int(step), len(schedule) - 1)])
