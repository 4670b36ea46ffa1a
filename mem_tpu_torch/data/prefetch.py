"""Batch prefetching: host thread, then the host->device copy one batch
ahead. Port of mem_tpu/data/prefetch.py.

``prefetch`` (a daemon thread that materialises host batches ahead) and
``chunk_batches`` are the reference's. ``device_prefetch`` replaces the
reference's ``jax.device_put`` look-ahead: each batch is copied into pinned
host memory and sent to the device with ``non_blocking=True`` on a side
stream; the consumer's stream waits on an event recorded after the copies,
and every device tensor is ``record_stream``-ed on the consumer's stream so
its memory is not handed out again before the step that reads it is done.

Under chained dispatch (``--steps_per_dispatch K``, train/chain.py) the items
are ``chunk_batches``' (k, ...) blocks: one pinned copy a chunk, issued one
chunk ahead. A graph chain's blocks carry the batch ops too
(``host_keys=()``: the chain chooses them on the device) and land straight
in the chain's static input slots (``into=chain.input_slots``), two sets a
chunk shape used in turn, so the next block's copy runs beside the replay.
"""
from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Iterable, Iterator

import numpy as np
import torch

from mem_tpu_torch.data.device_pipeline import HOST_KEYS

_SENTINEL = object()


def prefetch(it: Iterable, depth: int = 2) -> Iterator:
    """Wrap an iterator, materialising up to ``depth`` items ahead in a
    daemon thread. Exceptions propagate to the consumer; abandoning the
    generator stops the thread."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put_until_stopped(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not put_until_stopped(item):
                    return
        except BaseException as e:  # propagate into the consuming thread
            put_until_stopped(("__prefetch_error__", e))
            return
        put_until_stopped(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] == "__prefetch_error__":
                raise item[1]
            yield item
    finally:
        stop.set()


def chunk_batches(it: Iterable, k: int) -> Iterator:
    """Stack consecutive batches into (k, ...) blocks (the epoch tail
    yields a smaller block); k == 1 passes batches through."""
    buf = []
    for b in it:
        buf.append(b)
        if len(buf) == k:
            yield (buf[0] if k == 1
                   else {key: np.stack([x[key] for x in buf]) for key in buf[0]})
            buf = []
    if buf:
        yield (buf[0] if len(buf) == 1 and k == 1
               else {key: np.stack([x[key] for x in buf]) for key in buf[0]})


def host_tensors(batch: dict, host_keys=HOST_KEYS) -> dict:
    """numpy batch -> CPU tensors (uint32 seeds widened to int64); the
    ``host_keys`` draws stay numpy."""
    out = {}
    for k, v in batch.items():
        if k in host_keys:
            out[k] = v
            continue
        a = np.asarray(v)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        out[k] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def to_device(batch: dict, device, host_keys=HOST_KEYS) -> dict:
    """numpy batch -> tensors on ``device`` (a synchronous copy)."""
    return {k: v if k in host_keys else v.to(device)
            for k, v in host_tensors(batch, host_keys).items()}


def device_prefetch(it: Iterable, device, depth: int = 1, host_keys=HOST_KEYS,
                    into=None) -> Iterator:
    """Yield device batches, the copy of batch i + depth issued before batch
    i is handed out. On a CUDA device the copies run from pinned memory on a
    side stream; elsewhere this is :func:`to_device`. ``host_keys``: the
    draws that stay numpy (a graph chain's blocks pass ``()``). ``into``:
    None, or ``into(pinned item) -> dict`` of device tensors (or None) that
    the copy lands in instead of new memory, a graph chain's
    ``input_slots``: two sets handed out in turn, so ``depth`` is 1 there,
    and the copy waits for the work queued on the consumer's stream (the
    replay that last read the set)."""
    if into is not None and depth != 1:
        raise ValueError("copies into a chain's two sets of input slots need depth 1")
    device = torch.device(device)
    if device.type != "cuda":
        for item in it:
            yield to_device(item, device, host_keys)
        return
    side = torch.cuda.Stream(device)
    pending: deque = deque()

    def ready(pinned, dev, event):
        cur = torch.cuda.current_stream(device)
        cur.wait_event(event)
        for v in dev.values():
            if isinstance(v, torch.Tensor) and v.is_cuda:
                v.record_stream(cur)
        del pinned   # the pinned buffers were held until the copy was waited on
        return dev

    for item in it:
        pinned = {k: v if k in host_keys else v.pin_memory()
                  for k, v in host_tensors(item, host_keys).items()}
        slots = into({k: v for k, v in pinned.items() if k not in host_keys}) if into else None
        with torch.cuda.stream(side):
            if slots is None:
                dev = {k: v if k in host_keys else v.to(device, non_blocking=True)
                       for k, v in pinned.items()}
            else:
                side.wait_stream(torch.cuda.current_stream(device))
                dev = {k: v if k in host_keys else slots[k].copy_(v, non_blocking=True)
                       for k, v in pinned.items()}
            event = torch.cuda.Event()
            event.record(side)
        pending.append((pinned, dev, event))
        if len(pending) > depth:
            yield ready(*pending.popleft())
    while pending:
        yield ready(*pending.popleft())
