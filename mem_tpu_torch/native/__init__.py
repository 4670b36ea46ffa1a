"""ctypes bindings for the native event-IO runtime (libmemev).

The port's own copy of mem_tpu/native (memev.cpp is the same source). The
shared library is built on first use (g++ -O3) into
``mem_tpu_torch/_build/`` (git-ignored), not beside the source, and exposes
the raw-recording decoders and the threaded batch loaders:
  - decode_atis / decode_ncars: raw buffer -> (N, 4) float64 events, as
    events/decoders.py decodes them
  - load_batch / load_batch_xyp: .npy batch assembly -> (B, cap, 4) float32
    or the int16 [x, y, p] wire, + n_valid and per-sample extents
  - load_batch_imgnet: N-ImageNet .npz column reads
  - load_batch_dsec: the DSEC seg crop + slice + counting sort by y

This is host file IO, not device code. Every entry point returns None when
the toolchain is unavailable, and the callers then take their numpy paths
(events/decoders.py, data/pipeline.py, data/seg_pipeline.py); the tests
hold the two paths bit-equal.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Sequence

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "memev.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_SO = os.path.join(_BUILD_DIR, "libmemev.so")

_lib = None
_tried = False


def _build() -> bool:
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
             _SRC, "-o", tmp],
            check=True, capture_output=True,
        )
        os.replace(tmp, _SO)   # atomic: a concurrent loader never sees half a file
        return True
    except Exception as e:  # no g++, or it failed
        print(f"libmemev build failed ({e}); using numpy fallback")
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        if not _build():
            return None
    lib = ctypes.CDLL(_SO)
    for name in ("memev_decode_atis", "memev_decode_ncars"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_double)]
    lib.memev_load_batch.restype = ctypes.c_int64
    lib.memev_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32)]
    lib.memev_load_batch_xyp.restype = ctypes.c_int64
    lib.memev_load_batch_xyp.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32)]
    lib.memev_load_batch_dsec.restype = ctypes.c_int64
    lib.memev_load_batch_dsec.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int32)]
    lib.memev_load_batch_imgnet.restype = ctypes.c_int64
    lib.memev_load_batch_imgnet.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32)]
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def decode_atis(buf: bytes) -> Optional[np.ndarray]:
    """ATIS bytes -> (N, 4) float64 [y, x, t, 2p - 1], or None when the
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((len(buf) // 5, 4), dtype=np.float64)
    got = lib.memev_decode_atis(buf, len(buf),
                                out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out[:got]


def decode_ncars(buf: bytes) -> Optional[np.ndarray]:
    """N-Cars .dat bytes -> (N, 4) float64 [y, x, t, p], or None when the
    library is unavailable or the header runs past the buffer."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((max(len(buf) // 8, 1), 4), dtype=np.float64)
    got = lib.memev_decode_ncars(buf, len(buf),
                                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return None if got < 0 else out[:got]


def load_batch(paths: Sequence[str], slice_fracs: Sequence[float], cap: int,
               num_threads: int = 4):
    """Threaded native batch assembly; returns (events (B, cap, 4) f32,
    n_valid (B,) i32, maxxy (B, 2) i32 = (max_x+1, max_y+1)) or None when
    the library is unavailable. ``slice_fracs`` are host-sampled U[0,1)
    fractions deciding each SliceRandomMaxEvs window."""
    lib = get_lib()
    if lib is None:
        return None
    B = len(paths)
    events = np.zeros((B, cap, 4), dtype=np.float32)
    nvalid = np.zeros((B,), dtype=np.int32)
    maxxy = np.zeros((B, 2), dtype=np.int32)
    c_paths = (ctypes.c_char_p * B)(*[p.encode() for p in paths])
    c_fracs = (ctypes.c_double * B)(*[float(s) for s in slice_fracs])
    rc = lib.memev_load_batch(
        c_paths, c_fracs, B, cap, num_threads,
        events.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nvalid.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        maxxy.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise IOError(f"libmemev: failed loading {paths[rc - 1]!r}")
    return events, nvalid, maxxy


def load_batch_imgnet(paths: Sequence[str], slice_fracs: Sequence[float],
                      cap: int, scale_xy=None, num_threads: int = 4):
    """Threaded N-ImageNet .npz batch assembly: slice-first column reads
    (ZIP_STORED members parsed directly — no zipfile/crc32 pass), rows
    [x*sx, y*sy, t, 2p-1] float32, x/y rescaled in double before the single
    float round (bit-identical to the python columns path). Returns
    (events (B, cap, 4) f32, n_valid, maxxy) or None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    sx, sy = (1.0, 1.0) if scale_xy is None else (float(scale_xy[0]),
                                                  float(scale_xy[1]))
    B = len(paths)
    events = np.empty((B, cap, 4), dtype=np.float32)
    nvalid = np.zeros((B,), dtype=np.int32)
    maxxy = np.zeros((B, 2), dtype=np.int32)
    c_paths = (ctypes.c_char_p * B)(*[p.encode() for p in paths])
    c_fracs = (ctypes.c_double * B)(*[float(s) for s in slice_fracs])
    rc = lib.memev_load_batch_imgnet(
        c_paths, c_fracs, B, cap, sx, sy, num_threads,
        events.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nvalid.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        maxxy.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise IOError(f"libmemev: failed loading {paths[rc - 1]!r}")
    return events, nvalid, maxxy


def load_batch_dsec(paths: Sequence[str], slice_fracs: Sequence[float],
                    cap: int, seg_h: int = 440, num_threads: int = 4):
    """Threaded DSEC seg batch assembly: y<seg_h crop + SliceRandomMaxEvs
    over the kept rows + counting-sort by y (the host presort for the
    row-tiled Pallas histogram), emitted directly as the int16 [x, y, 2p-1]
    wire. Returns (events_xyp (B, cap, 3) int16, n_valid) or None."""
    lib = get_lib()
    if lib is None:
        return None
    B = len(paths)
    events = np.empty((B, cap, 3), dtype=np.int16)
    nvalid = np.zeros((B,), dtype=np.int32)
    c_paths = (ctypes.c_char_p * B)(*[p.encode() for p in paths])
    c_fracs = (ctypes.c_double * B)(*[float(s) for s in slice_fracs])
    rc = lib.memev_load_batch_dsec(
        c_paths, c_fracs, B, cap, seg_h, num_threads,
        events.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        nvalid.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise IOError(f"libmemev: failed loading {paths[rc - 1]!r}")
    return events, nvalid


def load_batch_xyp(paths: Sequence[str], slice_fracs: Sequence[float],
                   cap: int, num_threads: int = 4):
    """Compact-wire threaded batch assembly: returns (events_xyp (B, cap, 3)
    int16 [x, y, p], n_valid (B,) i32, maxxy (B, 2) i32) — the int16
    conversion happens inside the C read loop (zero extra host passes)."""
    lib = get_lib()
    if lib is None:
        return None
    B = len(paths)
    events = np.zeros((B, cap, 3), dtype=np.int16)
    nvalid = np.zeros((B,), dtype=np.int32)
    maxxy = np.zeros((B, 2), dtype=np.int32)
    c_paths = (ctypes.c_char_p * B)(*[p.encode() for p in paths])
    c_fracs = (ctypes.c_double * B)(*[float(s) for s in slice_fracs])
    rc = lib.memev_load_batch_xyp(
        c_paths, c_fracs, B, cap, num_threads,
        events.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        nvalid.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        maxxy.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise IOError(f"libmemev: failed loading {paths[rc - 1]!r}")
    return events, nvalid, maxxy
