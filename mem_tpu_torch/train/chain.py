"""Chained dispatch: K optimizer steps per host dispatch, port of the
"Chained dispatch" section of mem_tpu/train/steps.py (:16-28) and of the
``chain=True`` train-step factories there.

The JAX package ``lax.scan``s its step over a leading K axis of the batch,
so one host dispatch drives K optimizer steps on the device. Here a
:class:`Chain` runs a one-step ``body`` over a ``(k, ...)`` block in one of
two forms, chosen from the configuration before the first step
(:func:`eager_reason`) and named by :meth:`Chain.describe`:

- ``eager``: a Python loop over the block's k steps, each step's lr / wd
  (or the VAE's lr / temperature) a host float, RandAugment's batch ops
  read on the host, the step's update the step-at-a-time one. The CPU
  always runs this form; on the card it is the form of every placement and
  of the optimizers that a graph cannot hold.
- ``graph``: on the card, the same loop captured once for each chunk shape
  into a ``torch.cuda.CUDAGraph`` and replayed for every chunk of that
  shape. The block lies in static input slots (the prefetcher copies it
  there from pinned memory: :meth:`Chain.input_slots`; a block of other
  memory is copied in), each step's schedule values in a static (k,) slot
  that the step reads on the device (the optimizer's groups hold device
  tensors: ``optim.DeviceSchedule``), RandAugment's batch ops are chosen on
  the device, and the stacked metrics land in static outputs that each call
  hands back as copies. The first chunk of a run runs the same loop
  eagerly (on the capture stream: the optimizer's state, the kernels'
  libraries and cuDNN's plans are made there); capture itself runs
  nothing, so no step is lost or repeated. All graphs share one memory
  pool. A capture that fails raises.

In both forms one generator per chunk feeds dropout, drop-path, the MAE's
shuffle noise and IMNET's erasing fill, seeded from (seed, the chunk's first
step) as :func:`chunk_seed` says; each step draws on from where the last
stopped. The stream differs from the step-at-a-time one (one generator per
step) and is just as deterministic: the JAX chain makes the same trade
(per-step keys split from the chunk key). In the graph form the generator is
registered with every graph, so a replay draws the bits of its own seed.

A replay launches the hand-written kernels without calling their wrappers,
so each graph keeps the launch counts of its capture and adds them to
``mem_tpu_torch.kernels.launch_counts`` at every replay.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from mem_tpu_torch.data.device_pipeline import HOST_KEYS
from mem_tpu_torch.kernels import add_launches, launch_counts
from mem_tpu_torch.train.optim import DeviceSchedule, graph_refusal


def chunk_seed(seed: int, step: int) -> int:
    """The seed of the generator of the step ``step`` (the step-at-a-time
    runs) or of the chunk that starts there (the chains)."""
    return int(np.random.SeedSequence((int(seed), int(step))).generate_state(1)[0])


def eager_reason(device, optimizer, placement=None) -> Optional[str]:
    """Why a chain on ``device`` with ``optimizer`` and ``placement`` runs
    eagerly, or None where it runs as a graph."""
    device = torch.device(device)
    if device.type != "cuda":
        return f"device {device.type}"
    if placement is not None and placement.mode != "single":
        return f"placement {placement.mode}"
    return graph_refusal(optimizer)


def prefetch_args(step) -> dict:
    """The ``device_prefetch`` keywords (data/prefetch.py) of a train step:
    a chain's host keys and input slots, none for a step-at-a-time step."""
    if not hasattr(step, "input_slots"):
        return {}
    return {"host_keys": step.host_keys, "into": step.input_slots}


def step_of(block: dict, i: int) -> dict:
    """The i-th step's batch of a (k, ...) block."""
    return {key: v[i] for key, v in block.items()}


def block_length(block: dict) -> int:
    return next(v.shape[0] for v in block.values() if hasattr(v, "shape"))


class _Graph:
    """One captured chunk of k steps and its static tensors."""

    def __init__(self, graph, inputs, sched, outputs, launches, k):
        self.graph, self.inputs, self.sched, self.outputs = graph, inputs, sched, outputs
        self.launches = launches
        # the schedule values' pinned staging buffer and the event of its last copy
        self.sched_host = torch.empty((len(sched), k), dtype=torch.float32).pin_memory()
        self.sched_copied = None


def _signature(block: dict) -> tuple:
    return tuple((key, tuple(v.shape), v.dtype) for key, v in block.items())


class Chain:
    """``chain(block, it0, sched=None) -> {metric: (k,) tensor}``: the k
    steps of a (k, ...) block whose first step is the global step ``it0``.
    ``body(batch, generator, sched)`` is one step: a dict of the step's
    tensors, the chunk's generator, and the step's schedule values (host
    floats in the eager form, 0-d device tensors in the graph form); it
    returns 0-d metric tensors. ``sched_fn(it)`` gives a step's schedule
    values; a caller that walks its own schedule (the VAE's anneal) passes
    ``sched``, a dict of k-long lists, instead. ``optimizer`` and
    ``placement`` decide the form (:func:`eager_reason`); the graph form
    moves the optimizer's lr and wd onto the device (``DeviceSchedule``).

    ``host_keys``: the draws a block keeps as numpy for this form, so that
    the eager form picks RandAugment's batch ops on the host as the
    step-at-a-time run does; the graph form takes them on the device
    (``ops/rand_augment.py`` ``select_op``). :meth:`input_slots` gives the
    static tensors a block's copy to the card can land in."""

    def __init__(self, body: Callable, *, device, seed: int, optimizer, placement=None,
                 sched_fn: Optional[Callable] = None):
        self.body, self.seed, self.sched_fn = body, seed, sched_fn
        self.device, self.optimizer = torch.device(device), optimizer
        self.reason = eager_reason(self.device, optimizer, placement)
        self.form = "eager" if self.reason else "graph"
        self.host_keys = HOST_KEYS if self.reason else ()
        self.graphs: dict = {}
        self._warm = False
        if self.form == "graph":
            DeviceSchedule(optimizer, self.device)   # kept by the optimizer
            self.generator = torch.Generator(device=self.device)
            self.stream = torch.cuda.Stream(self.device)
            self.pool = None
            self.metric_dtypes: dict = {}
            self._slots: dict = {}   # block signature -> its two sets of input slots
            self._turn: dict = {}    # block signature -> the set the next copy lands in

    def describe(self, k: int) -> str:
        """The start line of a run: ``chain: graph K=8`` or ``chain: eager
        K=8 (<reason>)``."""
        return f"chain: graph K={k}" if self.form == "graph" else \
            f"chain: eager K={k} ({self.reason})"

    def input_slots(self, block: dict) -> Optional[dict]:
        """The graph form's static input tensors for a block like ``block``
        (host tensors of the chunk's shapes): two sets a shape, handed out in
        turn, so the copy of one chunk overlaps the replay of the one before
        (``data/prefetch.py`` ``device_prefetch(into=...)``). None in the
        eager form. A chunk in a set is replayed from it in place."""
        if self.form == "eager":
            return None
        sig = _signature(block)
        sets = self._slots.setdefault(sig, [None, None])
        turn = self._turn.get(sig, 0)
        self._turn[sig] = 1 - turn
        if sets[turn] is None:
            sets[turn] = {key: torch.empty(v.shape, dtype=v.dtype, device=self.device)
                          for key, v in block.items()}
        return sets[turn]

    def _sched(self, it0: int, k: int, sched) -> dict:
        if sched is None:
            if self.sched_fn is None:
                return {}
            per = [self.sched_fn(it0 + i) for i in range(k)]
            sched = {key: [p[key] for p in per] for key in per[0]}
        for key, v in sched.items():
            if len(v) != k:
                raise ValueError(f"schedule {key!r} has {len(v)} values for {k} steps")
        return sched

    def __call__(self, block: dict, it0: int, sched=None) -> dict:
        k = block_length(block)
        sched = self._sched(it0, k, sched)
        block = {key: v if key in self.host_keys and not torch.is_tensor(v)
                 else torch.as_tensor(v).to(self.device) for key, v in block.items()}
        if self.form == "eager":
            gen = torch.Generator(device=self.device)
            gen.manual_seed(chunk_seed(self.seed, it0))
            ms = [self.body(step_of(block, i), gen, {key: v[i] for key, v in sched.items()})
                  for i in range(k)]
            return {key: torch.stack([m[key] for m in ms]) for key in ms[0]}
        if not self._warm:
            return self._eager_chunk(block, it0, sched, k)
        key = self._slot_key(block)
        g = self.graphs.get(key) or self._capture(block, key, k)
        self._feed(g, block, sched)
        self.generator.manual_seed(chunk_seed(self.seed, it0))
        g.graph.replay()
        add_launches(g.launches)
        return {key: v.clone() for key, v in g.outputs.items()}

    def _slot_key(self, block: dict):
        """(signature, set) of the input slots ``block`` lies in, or
        (signature, None) for a block of other memory (copied in)."""
        sig = _signature(block)
        for turn, slots in enumerate(self._slots.get(sig, ())):
            if slots is not None and all(block[key] is slots[key] for key in slots):
                return sig, turn
        return sig, None

    def _feed(self, g: _Graph, block: dict, sched: dict) -> None:
        """Before a replay: a block of other memory into the graph's input
        slots, and each step's schedule values into theirs (one pinned copy,
        in stream order, from a buffer written once its last copy is done)."""
        for key, slot in g.inputs.items():
            if block[key] is not slot:
                slot.copy_(block[key], non_blocking=True)
        if not g.sched:
            return
        if g.sched_copied is not None:
            g.sched_copied.synchronize()
        g.sched_host.copy_(torch.tensor([sched[key] for key in g.sched], dtype=torch.float32))
        for row, slot in enumerate(g.sched.values()):
            slot.copy_(g.sched_host[row], non_blocking=True)
        g.sched_copied = torch.cuda.Event()
        g.sched_copied.record()

    def _loop(self, block: dict, sched: dict, k: int, outputs: Optional[dict] = None):
        """The k steps of the graph form: the step's schedule values are
        0-d views of the (k,) device slots."""
        ms = []
        for i in range(k):
            m = self.body(step_of(block, i), self.generator,
                          {key: v[i] for key, v in sched.items()})
            if outputs is not None:
                for key, out in outputs.items():
                    out[i].copy_(m[key])
            ms.append(m)
        return ms

    def _eager_chunk(self, block: dict, it0: int, sched: dict, k: int) -> dict:
        """The run's first chunk (the warm-up): the graph form's loop run
        eagerly on the capture stream."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            for v in block.values():
                v.record_stream(self.stream)
            slots = {key: torch.tensor(v, dtype=torch.float32, device=self.device)
                     for key, v in sched.items()}
            self.generator.manual_seed(chunk_seed(self.seed, it0))
            ms = self._loop(block, slots, k)
            out = {key: torch.stack([m[key] for m in ms]) for key in ms[0]}
        cur.wait_stream(self.stream)
        for v in out.values():
            v.record_stream(cur)
        self.metric_dtypes = {key: v.dtype for key, v in out.items()}
        self.sched_keys = tuple(sched)
        self._warm = True
        return out

    def _capture(self, block: dict, key, k: int) -> _Graph:
        """Capture the k-step loop on the input slots of ``key`` (a new set
        for a block of other memory); the static tensors live outside the
        graphs' pool, so no replay of another graph can reuse them."""
        sig, turn = key
        inputs = (self._slots[sig][turn] if turn is not None else
                  {name: torch.empty_like(v) for name, v in block.items()})
        sched = {name: torch.zeros(k, dtype=torch.float32, device=self.device)
                 for name in self.sched_keys}
        outputs = {name: torch.empty(k, dtype=dt, device=self.device)
                   for name, dt in self.metric_dtypes.items()}
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = launch_counts()
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            self._loop(inputs, sched, k, outputs)
        cur.wait_stream(self.stream)
        after = launch_counts()
        launches = {n: c - before.get(n, 0) for n, c in after.items() if c != before.get(n, 0)}
        add_launches({n: -c for n, c in launches.items()})   # capture launched nothing
        self.pool = graph.pool()
        self.graphs[key] = _Graph(graph, inputs, sched, outputs, launches, k)
        return self.graphs[key]
