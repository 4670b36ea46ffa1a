"""Host-side event-array augmentations (numpy), the port's own copy of
mem_tpu/events/augment.py.

They operate on ``(N, 4)`` float arrays with the downstream convention that
column 0 is "x" and column 1 is "y" (see ``decoders``' column-order quirk).
Semantics match the reference transforms (mem/datasets.py:464-609) but take
an explicit ``np.random.Generator``, so a draw is replayable. The device
pipeline folds the same augmentations into the voxelization as index
arithmetic; these are the host versions.
"""
from __future__ import annotations

import numpy as np


def slice_random_max_evs(events: np.ndarray, max_evs: int, rng: np.random.Generator) -> np.ndarray:
    """Keep a random contiguous window of at most ``max_evs`` events.

    Reference: SliceRandomMaxEvs, mem/datasets.py:488-498.
    """
    n = events.shape[0]
    if n <= max_evs:
        return events
    start = int(rng.integers(0, n - max_evs + 1))
    return events[start : start + max_evs]


def random_time_flip(events: np.ndarray, rng: np.random.Generator, p: float = 0.5) -> np.ndarray:
    """With probability ``p``: reverse event order, remap ``t <- t0 - t``
    (t0 = last timestamp), and negate polarity.

    Reference: RandomTimeFlip, mem/datasets.py:598-609.
    """
    if rng.random() < p:
        events = np.flip(events, axis=0).copy()
        events[:, 2] = events[0, 2] - events[:, 2]
        events[:, 3] = -events[:, 3]
    return events


def flip_events_x(
    events: np.ndarray, rng: np.random.Generator, W: int | None = None, p: float = 0.5
) -> np.ndarray:
    """With probability ``p``: horizontal flip ``x <- W-1-x``. If ``W`` is
    None it is inferred from the data as ``max(x)+1``.

    Reference: Aug_FlipEvsAlongX, mem/datasets.py:501-521.
    """
    if rng.random() < p:
        events = events.copy()
        w = W if W is not None else int(events[:, 0].max()) + 1
        events[:, 0] = w - 1 - events[:, 0]
    return events


def random_shift_events(
    events: np.ndarray,
    rng: np.random.Generator,
    max_shift: int,
    H: int | None = None,
    W: int | None = None,
) -> np.ndarray:
    """Shift all events by a random integer offset in ``[-max_shift, max_shift]``
    per axis, dropping events that leave ``[0, W) x [0, H)``. H/W inferred from
    data (max+1) when None.

    Reference: Aug_RandomShiftEvs, mem/datasets.py:524-549.
    """
    if max_shift <= 0:
        return events
    events = events.copy()
    w = W if W is not None else int(events[:, 0].max()) + 1
    h = H if H is not None else int(events[:, 1].max()) + 1
    x_shift, y_shift = rng.integers(-max_shift, max_shift + 1, size=(2,))
    events[:, 0] += x_shift
    events[:, 1] += y_shift
    valid = (
        (events[:, 0] >= 0)
        & (events[:, 0] < w)
        & (events[:, 1] >= 0)
        & (events[:, 1] < h)
    )
    return events[valid]


def reshape_scale_xy(
    events: np.ndarray,
    new_h: int,
    new_w: int,
    old_h: int = 480,
    old_w: int = 640,
    is_train: bool = True,
) -> np.ndarray:
    """N-ImageNet coordinate rescale.

    Train: scale so the short side becomes 256 (keeping aspect); val: scale
    exactly to (new_h, new_w). Reference: ReshapeScaleXandY,
    mem/datasets.py:464-485.
    """
    events = events.copy()
    if is_train:
        scale = 256.0 / min(old_h, old_w)
        sx, sy = scale, scale
    else:
        sx = new_w / old_w
        sy = new_h / old_h
    # Coordinates stay float here; integer truncation happens in the
    # rasterizer (matching reference: scale at datasets.py:483-485, truncate
    # at datasets.py:568-569).
    events[:, 0] = events[:, 0] * sx
    events[:, 1] = events[:, 1] * sy
    return events
