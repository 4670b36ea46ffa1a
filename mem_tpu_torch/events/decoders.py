"""Raw event-camera format decoders, the port's own copy of
mem_tpu/events/decoders.py.

Decodes binary AER recordings into ``(N, 4)`` float64 arrays of events.
The columns follow the reference datasets exactly, including their order
quirk: N-Caltech101 and N-Cars store ``[y, x, t, p]``, and the downstream
transforms treat column 0 as "x", so those datasets' histograms are
transposed relative to the sensor axes. Train and eval agree on it, and it
must stay for the port to match the reference:

  - N-Caltech101 (ATIS .bin): ``[y, x, t, p]`` with p in {-1.0, +1.0}
    (reference: process_data/process_dataset.py:24-63)
  - N-Cars (.dat): ``[y, x, t, p]`` with p in {0.0, 1.0}
    (reference: process_data/process_dataset.py:66-105)
  - N-ImageNet (.npz): the stored structured array as it is; the loader
    (data/folder.py) maps p to {-1, +1}
    (reference: process_data/process_dataset.py:108-117)

Decoding is vectorised numpy over the whole file buffer. The file decoders
take the C++ decoders of ``mem_tpu_torch.native`` when that library builds
(host IO, as the batch loaders are) and numpy otherwise; the two give
bit-equal arrays.
"""
from __future__ import annotations

import numpy as np


def decode_atis_bytes(buf: bytes | np.ndarray) -> np.ndarray:
    """Decode the ATIS 5-byte-per-event binary format (N-Caltech101).

    Layout per event (reference process_data/process_dataset.py:48-60):
      byte0 = y, byte1 = x, byte2 bit7 = polarity,
      (byte2 & 0x7f, byte3, byte4) = 23-bit big-endian timestamp.

    Returns ``(N, 4)`` float64 ``[y, x, t, p]`` with p mapped to ``2p - 1``.
    """
    raw = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
    n = raw.size // 5
    raw = raw[: n * 5].reshape(n, 5).astype(np.int64)
    p = (raw[:, 2] >> 7) & 0x01
    out = np.empty((n, 4), dtype=np.float64)
    out[:, 0] = raw[:, 0]
    out[:, 1] = raw[:, 1]
    out[:, 2] = ((raw[:, 2] & 0x7F) << 16) | (raw[:, 3] << 8) | raw[:, 4]
    out[:, 3] = 2.0 * p - 1.0
    return out


def _skip_ncars_header(raw: np.ndarray) -> int:
    """The offset just past the '%'-prefixed ASCII header and 2 more bytes
    (reference process_dataset.py:81-88: readline(256) while the line starts
    with '%', then skip 2 bytes)."""
    off = 0
    while off < raw.size and raw[off] == 0x25:  # '%'
        nl = np.flatnonzero(raw[off: off + 256] == 0x0A)
        off += min(256, raw.size - off) if nl.size == 0 else int(nl[0]) + 1
    return off + 2


def decode_ncars_bytes(buf: bytes | np.ndarray) -> np.ndarray:
    """Decode the N-Cars .dat format.

    Header: ASCII lines starting with '%', then 2 bytes to skip. Records are
    8 bytes: uint32 LE timestamp + uint32 LE packed word with y = bits 0-13,
    x = bits 14-27, p = bit 28 (reference process_dataset.py:90-103).

    Returns ``(N, 4)`` float64 ``[y, x, t, p]`` with p in {0.0, 1.0}, as
    the reference keeps it (the rasterizer's negative plane stays empty for
    N-Cars).
    """
    raw = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
    body = raw[_skip_ncars_header(raw):]
    n = body.size // 8
    words = body[: n * 8].view("<u4").reshape(n, 2).astype(np.int64)
    data = words[:, 1]
    out = np.empty((n, 4), dtype=np.float64)
    out[:, 0] = data & 0x00003FFF
    out[:, 1] = (data & 0x0FFFC000) >> 14
    out[:, 2] = words[:, 0]
    out[:, 3] = (data & 0x10000000) >> 28
    return out


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def decode_ncaltech101_file(path: str) -> np.ndarray:
    from mem_tpu_torch import native

    buf = _read(path)
    out = native.decode_atis(buf)
    return out if out is not None else decode_atis_bytes(buf)


def decode_ncars_file(path: str) -> np.ndarray:
    from mem_tpu_torch import native

    buf = _read(path)
    out = native.decode_ncars(buf)
    return out if out is not None else decode_ncars_bytes(buf)


def decode_nimagenet_file(path: str) -> np.ndarray:
    """An N-ImageNet .npz's ``event_data`` structured array as it is stored
    (reference process_dataset.py:108-117)."""
    return np.load(path)["event_data"]


def encode_atis_bytes(events: np.ndarray) -> bytes:
    """The inverse of :func:`decode_atis_bytes`: ``(N, 4)`` ``[y, x, t, p]``
    with p in {-1, +1} to ATIS bytes (writes seeded recordings)."""
    ev = np.asarray(events)
    n = ev.shape[0]
    raw = np.empty((n, 5), dtype=np.uint8)
    t = ev[:, 2].astype(np.int64)
    p = ((ev[:, 3] + 1) / 2).astype(np.int64)
    raw[:, 0] = ev[:, 0].astype(np.int64)
    raw[:, 1] = ev[:, 1].astype(np.int64)
    raw[:, 2] = ((p & 1) << 7) | ((t >> 16) & 0x7F)
    raw[:, 3] = (t >> 8) & 0xFF
    raw[:, 4] = t & 0xFF
    return raw.tobytes()


def encode_ncars_bytes(events: np.ndarray, header: bytes = b"% ncars\n") -> bytes:
    """The inverse of :func:`decode_ncars_bytes` (writes seeded
    recordings)."""
    ev = np.asarray(events)
    n = ev.shape[0]
    word = ((ev[:, 0].astype(np.uint32) & 0x3FFF)
            | ((ev[:, 1].astype(np.uint32) & 0x3FFF) << 14)
            | ((ev[:, 3].astype(np.uint32) & 0x1) << 28))
    body = np.empty((n, 2), dtype="<u4")
    body[:, 0] = ev[:, 2].astype(np.uint32)
    body[:, 1] = word
    return header + b"\x00\x00" + body.tobytes()
