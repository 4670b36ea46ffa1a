"""Planted faults of the trajectory check, and a survey of them on the card.

Each fault wraps the attention backward wrapper
``ops.attention.fused_attention_flat_bwd`` (K2b on the card, its plain
version on the CPU) for the duration of a ``with`` block:

- ``bias_held_from_first_launch``: the bias of the wrapper's first call is
  used by every later one (as a cache of its f32 copy keyed by shape would
  do). The first step is exact, so a one-step gate cannot see it; later
  steps recompute the probabilities with a rel-pos bias the table has since
  moved from. ``chip_smoke.py``'s ``trajectory_card`` phase plants it.
- ``db_halved``: the bias gradient halved (the candidate the trajectory
  check was first proposed with).
- ``dkdv_halved``, ``tail_dkdv_dropped`` (the keys of the last, ragged
  64-key tile get no dk / dv), ``cls_dq_dropped`` (the class token's query
  row gets no dq), ``db_transposed``.

``master_weights_in_bf16`` rounds every parameter to bf16 after each AdamW
update instead (the f32 master weights lost).

``python -m mem_tpu_torch.tools.trajectory_faults [steps] [out.json]``
(default 192 steps; on one card) runs the card phase's arms
(``trajectory.drift_arms`` on ``drift_inputs`` from the phase's seed:
oracle, A, B, C) and arm B under every fault, with each fault's one step
beside B's against the plain f32 step and the envelopes at windows 32 and
50; it prints them and, given ``out.json``, writes them there with the loss
curves. Without a card it exits 2.
"""
from __future__ import annotations

import contextlib
import json
import sys


def _wrapping(make):
    @contextlib.contextmanager
    def cm():
        from mem_tpu_torch.ops import attention as A

        real = A.fused_attention_flat_bwd
        A.fused_attention_flat_bwd = make(real)
        try:
            yield
        finally:
            A.fused_attention_flat_bwd = real
    cm.__name__ = make.__name__
    cm.__doc__ = make.__doc__
    return cm


@_wrapping
def bias_held_from_first_launch(real):
    held = {}

    def stale(q, k, v, bias, do, scale):
        return real(q, k, v, held.setdefault(bias.shape, bias.detach().clone()), do, scale)
    return stale


def _outputs(edit):
    """A fault that edits the backward's (dq, dk, dv, db)."""
    def make(real):
        return lambda q, k, v, bias, do, scale: edit(*real(q, k, v, bias, do, scale))
    make.__name__ = edit.__name__
    return _wrapping(make)


@_outputs
def db_halved(dq, dk, dv, db):
    return dq, dk, dv, db * 0.5


@_outputs
def dkdv_halved(dq, dk, dv, db):
    return dq, dk * 0.5, dv * 0.5, db


@_outputs
def tail_dkdv_dropped(dq, dk, dv, db):
    tail = (dk.shape[1] - 1) // 64 * 64
    dk, dv = dk.clone(), dv.clone()
    dk[:, tail:] = 0
    dv[:, tail:] = 0
    return dq, dk, dv, db


@_outputs
def cls_dq_dropped(dq, dk, dv, db):
    dq = dq.clone()
    dq[:, 0] = 0
    return dq, dk, dv, db


@_outputs
def db_transposed(dq, dk, dv, db):
    return dq, dk, dv, db.transpose(-1, -2).contiguous()


@contextlib.contextmanager
def master_weights_in_bf16():
    """Every parameter rounded to bf16 after each AdamW update (f32 master
    weights lost, the mixed-precision fault): the first step's gradients
    are exact; updates below bf16's resolution at the weight vanish."""
    import torch

    real = torch.optim.AdamW.step

    def step(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        with torch.no_grad():
            for group in self.param_groups:
                for p in group["params"]:
                    p.copy_(p.to(torch.bfloat16))
        return out

    torch.optim.AdamW.step = step
    try:
        yield
    finally:
        torch.optim.AdamW.step = real


FAULTS = {f.__name__: f for f in (bias_held_from_first_launch, db_halved, dkdv_halved,
                                  tail_dkdv_dropped, cls_dq_dropped, db_transposed,
                                  master_weights_in_bf16)}


def main(argv=None) -> int:
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("trajectory_faults: no CUDA device is available", file=sys.stderr)
        return 2
    import numpy as np

    from mem_tpu_torch.kernels import build
    from mem_tpu_torch.tools import trajectory as T
    from mem_tpu_torch.utils import env

    argv = sys.argv[1:] if argv is None else argv
    steps = int(argv[0]) if argv else 192
    path = argv[1] if len(argv) > 1 else None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.library()
    with tempfile.TemporaryDirectory() as tmp:
        data, tokenizer, inits = T.drift_inputs(tmp, np.random.default_rng(25))
        out = T.drift_arms(data, tokenizer, inits, torch.device("cuda"), steps, 10, FAULTS)
    runs = out.pop("runs")
    out.update(gpu=env.probe()["nvidia_smi"], steps=steps,
               curves={k: r["loss"] for k, r in runs.items()},
               ms_per_step={k: r["ms_per_step"] for k, r in runs.items()},
               launches={k: r["launches"] for k, r in runs.items()})
    for w in (32, 50):
        out[f"window_{w}"] = {k: T.drift_envelope(runs["oracle"]["loss"], runs["A"]["loss"],
                                                  runs[k]["loss"], runs["C"]["loss"], w)
                              for k in ["B", *FAULTS]}
    if path is not None:
        with open(path, "w") as f:
            json.dump(out, f, indent=1, default=str)
    print(json.dumps({k: v for k, v in out.items() if k != "curves"}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
