"""Step-resolution schedules. ``cosine_scheduler``, port of
mem_tpu/train/schedules.py (mem/utils.py:395-412): linear warmup
(``warmup_steps`` overrides ``warmup_epochs``), then cosine from base to
final over the remaining steps, as a numpy array with one value per step.
``poly_lr_schedule``, port of mem_tpu/cli/train_seg.py:47-59: the mmseg poly
policy of segmentation training, as a step -> lr function.
``VaeAnnealState``, port of mem_tpu/train/schedules.py:58-98: the VAE's
coupled lr decay and Gumbel-temperature anneal."""
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


def poly_lr_schedule(base_lr: float, max_iters: int, power: float = 1.0,
                     warmup_iters: int = 1500, warmup_ratio: float = 1e-6,
                     min_lr: float = 0.0):
    """mmseg poly policy (mem_224_160k.py:88-92): linear warm-up from
    ``warmup_ratio * base_lr`` over ``warmup_iters`` steps, then (base_lr -
    min_lr) * (1 - step / max_iters) ** power + min_lr. Evaluated in f32, in
    the reference's order of operations, so that the two agree to an ulp."""
    f = np.float32

    def fn(step) -> float:
        step = f(step)
        warm = f(base_lr) * (f(warmup_ratio)
                             + f(1 - warmup_ratio) * step / f(max(warmup_iters, 1)))
        frac = np.clip(f(1.0) - step / f(max_iters), f(0.0), f(1.0))
        main = f(base_lr - min_lr) * np.power(frac, f(power)) + f(min_lr)
        return float(warm if step < warmup_iters else main)

    return fn


class VaeAnnealState:
    """The reference VAE's coupled lr decay and Gumbel-temperature anneal
    (train_vae.py:342-353). Both change only after a step whose within-epoch
    index ``i`` is a multiple of ``every`` (10,000), so once per epoch at
    i = 0 for epochs shorter than that (the reference's quirk), and take
    effect from the next step::

        for i, batch in enumerate(loader):
            train_step(batch, ..., lr=state.lr, temp=state.temp)
            state.after_step(i)
    """

    def __init__(self, base_lr: float, lr_decay: float, starting_temp: float = 1.0,
                 anneal_rate: float = 1e-6, temp_min: float = 0.5, every: int = 10000):
        self.lr = base_lr
        self.lr_decay = lr_decay
        self.temp = starting_temp
        self.anneal_rate = anneal_rate
        self.temp_min = temp_min
        self.every = every
        self.global_step = 0

    def after_step(self, i: int) -> None:
        if i % self.every == 0:
            self.temp = max(self.temp * math.exp(-self.anneal_rate * self.global_step),
                            self.temp_min)
            self.lr *= self.lr_decay
        self.global_step += 1
