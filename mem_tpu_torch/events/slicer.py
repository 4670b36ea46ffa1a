"""Complete EventSlicer for DSEC events.h5 files, the port's own copy of
mem_tpu/events/slicer.py. It takes an open ``h5py.File`` and imports
nothing of h5py itself, so the module imports where h5py is missing.

The reference vendors an *incomplete* EventSlicer (process_data/utils.py:6-67
calls three methods that were never copied in, so the DSEC decode path
crashes as shipped — SURVEY §2.11(3)). This is a complete implementation of
the same contract: millisecond-index binary search into the HDF5 event
stream using the file's ``ms_to_idx`` table, returning the event slice in a
[t_start_us, t_end_us) window.

DSEC file layout: ``events/{x,y,t,p}`` arrays, ``ms_to_idx`` (int64, index of
the first event with t >= ms*1000), ``t_offset`` (us).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np


class EventSlicer:
    def __init__(self, h5f):
        self.h5f = h5f
        self.events = {k: h5f["events"][k] for k in ("x", "y", "t", "p")}
        self.ms_to_idx = np.asarray(h5f["ms_to_idx"], dtype=np.int64)
        self.t_offset = int(np.asarray(h5f["t_offset"])) if "t_offset" in h5f else 0
        self.t_final = int(self.events["t"][-1]) + self.t_offset

    def get_start_time_us(self) -> int:
        return self.t_offset

    def get_final_time_us(self) -> int:
        return self.t_final

    @staticmethod
    def get_conservative_window_ms(ts_start_us: float, ts_end_us: float):
        """Round outward to whole milliseconds."""
        assert ts_end_us > ts_start_us
        return math.floor(ts_start_us / 1000), math.ceil(ts_end_us / 1000)

    def ms2idx(self, time_ms: int) -> Optional[int]:
        assert time_ms >= 0
        if time_ms >= self.ms_to_idx.size:
            return None
        return int(self.ms_to_idx[time_ms])

    @staticmethod
    def get_time_indices_offsets(time_array: np.ndarray, ts_start_us: int, ts_end_us: int):
        """(idx_start, idx_end) into ``time_array`` such that
        time_array[idx_start:idx_end] lies in [ts_start_us, ts_end_us)."""
        idx_start = int(np.searchsorted(time_array, ts_start_us, side="left"))
        idx_end = int(np.searchsorted(time_array, ts_end_us, side="left"))
        return idx_start, idx_end

    def get_events(self, t_start_us: float, t_end_us: float) -> Optional[Dict[str, np.ndarray]]:
        """Events in [t_start_us, t_end_us); timestamps include t_offset."""
        t_start_us = int(t_start_us) - self.t_offset
        t_end_us = int(t_end_us) - self.t_offset
        if t_start_us < 0:
            t_start_us = 0
        if t_end_us <= t_start_us:
            return None

        ms_lo, ms_hi = self.get_conservative_window_ms(max(t_start_us, 0) + 1e-9, t_end_us)
        lo = self.ms2idx(max(ms_lo, 0))
        hi = self.ms2idx(ms_hi)
        if lo is None:
            return None
        if hi is None:
            hi = self.events["t"].shape[0]
        if hi <= lo:
            return None

        t_window = np.asarray(self.events["t"][lo:hi], dtype=np.int64)
        i0, i1 = self.get_time_indices_offsets(t_window, t_start_us, t_end_us)
        if i1 <= i0:
            return None
        out = {"t": t_window[i0:i1] + self.t_offset}
        for k in ("x", "y", "p"):
            out[k] = np.asarray(self.events[k][lo + i0 : lo + i1])
        return out
