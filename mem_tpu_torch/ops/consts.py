"""Small constant tensors of the train steps, made once per device and kept.

A CUDA graph cannot capture the copy of a host value to the card, and the
chains of train/chain.py capture whole train steps. Each constant the steps
build from host values (a channel mask, luma weights, RandAugment's
magnitude table, the PSP pooling matrices) therefore comes from here: the
first call, in the chain's eager warm-up (or any step-at-a-time run), makes
it on the device, and every later call, a capture included, gets the same
tensor back. Callers must not write to it.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

_lock = threading.Lock()
_made: dict = {}


def cached(key, dtype, device, make) -> torch.Tensor:
    """``make()`` (a CPU tensor or a numpy array) as ``dtype`` on ``device``,
    made once for ``key`` (hashable: the values the constant depends on)."""
    full = (key, dtype, str(torch.device(device)))
    with _lock:
        t = _made.get(full)
        if t is None:   # a normal tensor even when first asked for under inference_mode
            with torch.inference_mode(False):
                t = _made[full] = torch.as_tensor(make()).to(device=device, dtype=dtype)
        return t


def constant(values, dtype, device) -> torch.Tensor:
    """The tensor of ``values`` (a number or a tuple) on ``device``."""
    return cached(("values", values), dtype, device, lambda: torch.tensor(values, dtype=dtype))


def as_f32(x, device) -> torch.Tensor:
    """``x`` as f32 on ``device``: a tensor moved, a number a kept constant
    (``torch.as_tensor(x, dtype=float32, device=device)``)."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32)
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x, dtype=torch.float32, device=device)
    return constant(float(x), torch.float32, device)
