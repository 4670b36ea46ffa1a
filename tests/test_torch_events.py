"""The port's raw-recording decoders, the DSEC slicer and the host event
augmentations held against the JAX package's (mem_tpu/events): the
decoders and encoders byte for byte on the cases of test_decoders.py, the
port's native decoders against its numpy ones bit for bit, the slicer on
the cases of test_event_slicer.py, and the five augmentations under one
``np.random.Generator`` seed."""
import numpy as np
import pytest

import mem_tpu.events.augment as jax_augment
import mem_tpu.events.decoders as jax_decoders
from mem_tpu_torch import native
from mem_tpu_torch.events import augment, decoders


def _atis_events(rng, n=500):
    return np.stack([rng.integers(0, 240, n), rng.integers(0, 256, n),
                     np.sort(rng.integers(0, 2**23, n)), rng.choice([-1.0, 1.0], n)],
                    axis=1).astype(np.float64)


def _ncars_events(rng, n=300):
    return np.stack([rng.integers(0, 100, n), rng.integers(0, 120, n),
                     np.sort(rng.integers(0, 10**6, n)), rng.integers(0, 2, n)],
                    axis=1).astype(np.float64)


def _buffers(rng):
    """The byte strings of test_decoders.py (handcrafted events, random
    bytes with a ragged tail, encoded event arrays) and the edge cases."""
    word = 5 | (9 << 14) | (1 << 28)
    body = np.array([(1000, word)], dtype="<u4,<u4").view("<u4").tobytes()
    return {
        "atis": [bytes([3, 7, 0x80 | 0x12, 0x34, 0x56]), bytes([255, 0, 0x7F, 0xFF, 0xFF]),
                 rng.integers(0, 256, size=5 * 1000 + 3, dtype=np.uint8).tobytes(),
                 jax_decoders.encode_atis_bytes(_atis_events(rng)), b"", b"\x01\x02"],
        "ncars": [b"% header line\n% another\n" + b"\x00\x00" + body,
                  jax_decoders.encode_ncars_bytes(_ncars_events(rng)),
                  b"%" + b"x" * 300 + b"\n\x00\x00" + body,     # a line past readline(256)
                  b"\x00\x00" + body + b"\x01\x02\x03",         # no header, ragged tail
                  b"% only a header\n"],
    }


@pytest.mark.parametrize("fmt", ["atis", "ncars"])
def test_decoders_match_jax_byte_for_byte(rng, fmt):
    port = {"atis": decoders.decode_atis_bytes, "ncars": decoders.decode_ncars_bytes}[fmt]
    ref = {"atis": jax_decoders.decode_atis_bytes,
           "ncars": jax_decoders.decode_ncars_bytes}[fmt]
    for buf in _buffers(rng)[fmt]:
        got, want = port(buf), ref(buf)
        assert got.dtype == want.dtype == np.float64
        assert got.tobytes() == want.tobytes() and got.shape == want.shape
        got_arr = port(np.frombuffer(buf, dtype=np.uint8))
        assert got_arr.tobytes() == want.tobytes()


def test_decoders_keep_the_column_quirk_and_polarities(rng):
    buf = bytes([3, 7, 0x80 | 0x12, 0x34, 0x56])
    assert list(decoders.decode_atis_bytes(buf)[0]) == [3.0, 7.0, 0x123456, 1.0]   # [y, x, t, p]
    ev = decoders.decode_ncars_bytes(decoders.encode_ncars_bytes(_ncars_events(rng)))
    assert set(np.unique(ev[:, 3])) <= {0.0, 1.0}
    atis = decoders.decode_atis_bytes(decoders.encode_atis_bytes(_atis_events(rng)))
    assert set(np.unique(atis[:, 3])) == {-1.0, 1.0}


@pytest.mark.parametrize("fmt", ["atis", "ncars"])
def test_encoders_match_jax_byte_for_byte(rng, fmt):
    ev = _atis_events(rng) if fmt == "atis" else _ncars_events(rng)
    port = {"atis": decoders.encode_atis_bytes, "ncars": decoders.encode_ncars_bytes}[fmt]
    ref = {"atis": jax_decoders.encode_atis_bytes,
           "ncars": jax_decoders.encode_ncars_bytes}[fmt]
    assert port(ev) == ref(ev)
    dec = decoders.decode_atis_bytes if fmt == "atis" else decoders.decode_ncars_bytes
    np.testing.assert_array_equal(dec(port(ev)), ev)
    if fmt == "ncars":
        assert port(ev, header=b"% a\n% b\n") == ref(ev, header=b"% a\n% b\n")


@pytest.mark.parametrize("fmt", ["atis", "ncars"])
def test_native_decoders_bit_equal_to_numpy(rng, fmt):
    if not native.available():
        pytest.skip("libmemev does not build here (no g++)")
    nat = {"atis": native.decode_atis, "ncars": native.decode_ncars}[fmt]
    ref = {"atis": decoders.decode_atis_bytes, "ncars": decoders.decode_ncars_bytes}[fmt]
    for buf in _buffers(rng)[fmt]:
        got = nat(buf)
        if got is None:   # a header past the buffer: the numpy path takes it
            assert fmt == "ncars" and ref(buf).shape == (0, 4)
            continue
        want = ref(buf)
        assert got.tobytes() == want.tobytes() and got.shape == want.shape


def test_file_decoders_take_either_path(rng, tmp_path, monkeypatch):
    ev = _atis_events(rng)
    (tmp_path / "a.bin").write_bytes(decoders.encode_atis_bytes(ev))
    (tmp_path / "c.dat").write_bytes(decoders.encode_ncars_bytes(_ncars_events(rng)))
    for library in (True, False):
        if not library:   # as where libmemev does not build: the numpy decoders
            monkeypatch.setattr(native, "decode_atis", lambda buf: None)
            monkeypatch.setattr(native, "decode_ncars", lambda buf: None)
        a = decoders.decode_ncaltech101_file(str(tmp_path / "a.bin"))
        c = decoders.decode_ncars_file(str(tmp_path / "c.dat"))
        assert a.tobytes() == jax_decoders.decode_ncaltech101_file(str(tmp_path / "a.bin")).tobytes()
        assert c.tobytes() == jax_decoders.decode_ncars_file(str(tmp_path / "c.dat")).tobytes()
    rec = np.zeros(50, dtype=[("x", "<u2"), ("y", "<u2"), ("t", "<i8"), ("p", "u1")])
    rec["x"] = rng.integers(0, 640, 50)
    np.savez(tmp_path / "n.npz", event_data=rec)
    got = decoders.decode_nimagenet_file(str(tmp_path / "n.npz"))
    assert got.tobytes() == jax_decoders.decode_nimagenet_file(str(tmp_path / "n.npz")).tobytes()


# -- the DSEC slicer ---------------------------------------------------------

@pytest.fixture
def h5file(tmp_path, rng):
    h5py = pytest.importorskip("h5py")
    n = 50000
    t = np.sort(rng.integers(0, 3_000_000, n)).astype(np.int64)
    ms_to_idx = np.searchsorted(t, np.arange(int(t[-1] // 1000) + 2) * 1000).astype(np.int64)
    path = tmp_path / "events.h5"
    with h5py.File(path, "w") as f:
        g = f.create_group("events")
        g["t"], g["x"] = t, rng.integers(0, 640, n).astype(np.uint16)
        g["y"], g["p"] = rng.integers(0, 480, n).astype(np.uint16), rng.integers(0, 2, n).astype(np.uint8)
        f["ms_to_idx"] = ms_to_idx
        f["t_offset"] = np.int64(1_000_000)
    return str(path), h5py


def test_slicer_matches_jax(h5file, rng):
    from mem_tpu.events.slicer import EventSlicer as JaxSlicer
    from mem_tpu_torch.events.slicer import EventSlicer

    path, h5py = h5file
    windows = [(1_500_000, 1_700_000), (10, 5), (500_000_000, 500_100_000), (0, 1_000_500),
               (3_999_000, 4_100_000)]
    for _ in range(10):
        a = int(rng.integers(1_000_000, 3_800_000))
        windows.append((a, a + int(rng.integers(1_000, 400_000))))
    with h5py.File(path) as f:
        port, ref = EventSlicer(f), JaxSlicer(f)
        assert port.get_start_time_us() == ref.get_start_time_us() == 1_000_000
        assert port.get_final_time_us() == ref.get_final_time_us()
        for a, b in windows:
            got, want = port.get_events(a, b), ref.get_events(a, b)
            assert (got is None) == (want is None), (a, b)
            if got is not None:
                assert set(got) == set(want)
                for k in want:
                    assert got[k].dtype == want[k].dtype
                    np.testing.assert_array_equal(got[k], want[k])


# -- the host augmentations --------------------------------------------------

def _events(rng, n=2000):
    ev = np.zeros((n, 4))
    ev[:, 0] = rng.integers(0, 304, n)
    ev[:, 1] = rng.integers(0, 240, n)
    ev[:, 2] = np.sort(rng.integers(0, 10**6, n))
    ev[:, 3] = rng.choice([-1.0, 1.0], n)
    return ev


@pytest.mark.parametrize("name,kwargs", [
    ("slice_random_max_evs", dict(max_evs=700)), ("slice_random_max_evs", dict(max_evs=5000)),
    ("random_time_flip", dict(p=0.5)), ("flip_events_x", dict(p=0.5)),
    ("flip_events_x", dict(W=320, p=0.9)), ("random_shift_events", dict(max_shift=20)),
    ("random_shift_events", dict(max_shift=20, H=260, W=320)),
    ("random_shift_events", dict(max_shift=0)),
    ("reshape_scale_xy", dict(new_h=224, new_w=224)),
    ("reshape_scale_xy", dict(new_h=224, new_w=224, is_train=False)),
])
def test_augmentations_bit_equal_to_jax(rng, name, kwargs):
    ev = _events(rng)
    ev0 = ev.copy()
    port, ref = getattr(augment, name), getattr(jax_augment, name)
    for seed in range(6):
        g_port, g_ref = np.random.default_rng(seed), np.random.default_rng(seed)
        if name == "reshape_scale_xy":
            got, want = port(ev, **kwargs), ref(ev, **kwargs)
        elif name == "slice_random_max_evs":
            got, want = port(ev, rng=g_port, **kwargs), ref(ev, rng=g_ref, **kwargs)
        else:
            got, want = port(ev, g_port, **kwargs), ref(ev, g_ref, **kwargs)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), (name, seed)
        assert g_port.bit_generator.state == g_ref.bit_generator.state
    assert ev.tobytes() == ev0.tobytes()   # the input is never changed in place


def test_events_package_exports_the_reference_s():
    import mem_tpu.events as jax_events
    import mem_tpu_torch.events as events

    names = {n for n in dir(jax_events) if not n.startswith("_")} - {"augment", "decoders"}
    assert names <= set(dir(events))
