"""Exact-resume instruments for the epoch-based training CLIs.

A run recycled at every epoch boundary (``--rss_restart_gb`` below any real
resident set: save, exit 3, relaunch, auto-resume) should end where a run
that never stopped ends. Each step's generator is seeded from (seed, global
step) (``train/steps.py`` ``step_generator``) and the data order from (seed,
epoch, index), so on one device in one precision the claim is bit-equality:
every step's loss, the weights and the optimizer state (and the EMA).

- :func:`record_steps` records (global step, loss) of every step that a CLI
  module's ``main`` takes, also across a ``SystemExit``;
- :func:`plant` holds one of :data:`FAULTS` for the calls inside it;
- :func:`run_recycled` calls ``main`` in this process until it stops
  exiting with ``RESTART_EXIT_CODE``;
- :func:`state_diffs` names the tensors and values of two checkpoints that
  differ;
- :func:`loss_continuity` is the reference soak's loss-continuity gate
  (scripts/soak_pretrain.py), which looks only at the logged losses.

Run as a program, it is one training process with a record::

    python -m mem_tpu_torch.tools.resume <record.jsonl> <cli> [--plant F] [flags]

imports ``mem_tpu_torch.cli.<cli>``, runs its ``main(flags)`` and, however
the process ends (0, a recycle's 3, an error), appends one JSON line to
``record.jsonl``: the pid, the exit code, the recorded steps ``[[step,
loss], ...]`` and the process's kernel launch counts. Under
``scripts/run_resilient.sh`` each relaunch appends its own line.

The module imports no torch until a function needs it, so a process that
only reads records (``tools/soak.py``) stays free of CUDA state.
"""
from __future__ import annotations

import contextlib
import json
import os
import signal
import sys

import numpy as np

from mem_tpu_torch import _signals
from mem_tpu_torch.utils.preemption import RESTART_EXIT_CODE

# the step factories each CLI module builds its training step from
STEP_FACTORIES = {
    "train_vae": ("make_vae_train_step",),
    "run_mem_pretraining": ("make_pretrain_train_step", "make_mae_train_step"),
    "run_class_finetuning": ("make_finetune_train_step",),
}

# planted faults of a resume; each must fail the exact-resume gate
FAULTS = (
    "no_optimizer_state",   # the model is restored, the optimizer starts fresh
    "global_step_zero",     # each process counts its steps from 0 again
)


def cli_module(name: str):
    import importlib

    return importlib.import_module(f"mem_tpu_torch.cli.{name}")


@contextlib.contextmanager
def _wrapped_factories(module, wrap):
    names = STEP_FACTORIES[module.__name__.rsplit(".", 1)[-1]]
    saved = {n: getattr(module, n) for n in names}
    try:
        for n, f in saved.items():
            setattr(module, n, wrap(f))
        yield
    finally:
        for n, f in saved.items():
            setattr(module, n, f)


def _standing_in(step, fn):
    """``fn`` in place of the train step ``step``: a chain's (train/chain.py)
    ``describe``, host keys and input slots stay readable."""
    for name in ("describe", "host_keys", "input_slots"):
        if hasattr(step, name):
            setattr(fn, name, getattr(step, name))
    return fn


@contextlib.contextmanager
def record_steps(module):
    """Yields a list that fills with (global step, loss tensor) for every
    training step that ``module.main`` takes inside the block (read the
    losses with :func:`losses`); a chain's call records each of its steps."""
    record = []

    def wrap(factory):
        def make(*a, **k):
            step = factory(*a, **k)

            def recorded(batch, it, *rest, **kw):
                m = step(batch, it, *rest, **kw)
                loss = m["loss"].detach()
                record.extend((int(it) + j, v) for j, v in enumerate(loss.reshape(-1)))
                return m
            return _standing_in(step, recorded)
        return make

    with _wrapped_factories(module, wrap):
        yield record


def losses(record) -> list:
    """``[[step, loss], ...]`` as Python floats (exact for f32 losses)."""
    return [[it, float(loss)] for it, loss in record]


@contextlib.contextmanager
def plant(module, fault: str):
    """Hold ``fault`` (one of :data:`FAULTS`) for the ``main`` calls inside."""
    if fault == "no_optimizer_state":
        import torch

        restore = torch.optim.Optimizer.load_state_dict
        torch.optim.Optimizer.load_state_dict = lambda self, state: None
        try:
            yield
        finally:
            torch.optim.Optimizer.load_state_dict = restore
    elif fault == "global_step_zero":
        def wrap(factory):
            def make(*a, **k):
                step, first = factory(*a, **k), []

                def restarted(batch, it, *rest, **kw):
                    if not first:
                        first.append(it)
                    return step(batch, it - first[0], *rest, **kw)
                return _standing_in(step, restarted)
            return make

        with _wrapped_factories(module, wrap):
            yield
    else:
        raise ValueError(f"unknown fault {fault!r}; expected one of {FAULTS}")


def run_recycled(module, argv) -> int:
    """``module.main(argv)`` again and again while it exits with
    ``RESTART_EXIT_CODE`` (scripts/run_resilient.sh in one process); the
    SIGTERM handler is put back after each call. Returns the recycles."""
    recycles = 0
    while True:
        previous = signal.getsignal(signal.SIGTERM)
        try:
            module.main(argv)
            return recycles
        except SystemExit as e:
            if e.code != RESTART_EXIT_CODE:
                raise
            recycles += 1
        finally:
            signal.signal(signal.SIGTERM, previous)


def state_diffs(a, b, path: str = "") -> list:
    """The paths at which two checkpoint payloads differ: tensors by
    ``torch.equal``, other values by ``==``, keys by name."""
    import torch

    if isinstance(a, dict) and isinstance(b, dict):
        out = [f"{path}.{k}: only on one side" for k in sorted(set(a) ^ set(b), key=str)]
        for k in sorted(set(a) & set(b), key=str):
            out += state_diffs(a[k], b[k], f"{path}.{k}")
        return out
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        out = [] if len(a) == len(b) else [f"{path}: length {len(a)} vs {len(b)}"]
        for i, (x, y) in enumerate(zip(a, b)):
            out += state_diffs(x, y, f"{path}[{i}]")
        return out
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        same = a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
        return [] if same else [f"{path}: tensors differ"]
    return [] if a == b else [f"{path}: {a!r} vs {b!r}"]


def loss_continuity(loss_values, resume_index) -> dict:
    """The reference soak's gate (scripts/soak_pretrain.py ``main``): the
    largest jump between the last loss before a resume and the first after
    it (``resume_index`` are the positions of those first losses) against
    ``max(within, 0.5)``, where ``within`` is the largest move between any
    two adjacent losses of the series. As the reference computes it,
    ``within`` takes in the resume jumps themselves, so the gate cannot
    fail; ``max_step_between_resumes`` leaves them out, for the record."""
    la = np.asarray(loss_values, dtype=np.float64)
    steps = np.abs(np.diff(la))
    within = float(steps.max()) if len(la) > 1 else 0.0
    at = {i for i in resume_index if 0 < i < len(la)}
    jumps = [float(steps[i - 1]) for i in sorted(at)]
    inner = [float(s) for i, s in enumerate(steps, 1) if i not in at]
    max_jump = max(jumps, default=0.0)
    return {"max_within_segment_loss_step": within, "max_resume_loss_jump": max_jump,
            "max_step_between_resumes": max(inner, default=0.0),
            "resume_jumps": jumps, "ok": max_jump <= max(within, 0.5)}


def read_records(path: str) -> list:
    """The JSON lines that the processes of one run appended to ``path``."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    _signals.latch()   # before torch loads, as the CLIs do
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    record_path, cli, flags = argv[0], argv[1], argv[2:]
    fault = None
    if flags[:1] == ["--plant"]:
        fault, flags = flags[1], flags[2:]
    module = cli_module(cli)
    from mem_tpu_torch.kernels import launch_counts

    code = 0
    # the fault inside the record: the record keeps the CLI's own steps
    with plant(module, fault) if fault else contextlib.nullcontext(), \
            record_steps(module) as record:
        try:
            module.main(flags)
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else 1
        except BaseException:
            code = 1
            raise
        finally:
            with open(record_path, "a") as f:
                f.write(json.dumps({"pid": os.getpid(), "cli": cli, "fault": fault,
                                    "exit": code, "steps": losses(record),
                                    "launches": launch_counts()}) + "\n")
    return code


if __name__ == "__main__":
    sys.exit(main())
