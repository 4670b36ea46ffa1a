"""Memory-safety fuzz of the port's libmemev (mem_tpu_torch/native/memev.cpp)
under ASAN + UBSan: the counterpart of tests/test_native_fuzz.py.

The reference's deterministic corpus (truncations, header mutations, bit
flips and random blobs around every format the library reads; that test's
``_corpus``) drives every C entry point of a sanitizer build of the port's
source through scripts/fuzz_memev.py, unchanged: the script is numpy and
ctypes only, and the port's C ABI is the reference's. The build goes to a
path of this test's own, so it never races the reference test's
``/tmp/libmemev_asan.so`` under a parallel runner. Beside it: a corrupt file
fails its own item, not the batch, in the port's bindings; and over the
whole corpus the port's loaders return the JAX package's arrays, or raise
for the same item.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from mem_tpu import native as ref_native
from mem_tpu_torch import native
from test_native_fuzz import _corpus

pytestmark = pytest.mark.skipif(not (native.available() and ref_native.available()),
                                reason="no g++/libmemev")

_SRC = os.path.join(os.path.dirname(native.__file__), "memev.cpp")
_HARNESS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                        "fuzz_memev.py")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fuzz") / "corpus")
    n = _corpus(root, np.random.default_rng(1234))
    assert n > 120
    return root, n


@pytest.fixture(scope="module")
def asan_so(tmp_path_factory):
    """The reference test's sanitizer flags on the port's source."""
    so = str(tmp_path_factory.mktemp("asan") / "libmemev_torch_asan.so")
    r = subprocess.run(["g++", "-g", "-O1", "-std=c++17", "-shared", "-fPIC", "-pthread",
                        "-fsanitize=address,undefined", "-fno-sanitize-recover=all", _SRC,
                        "-o", so], capture_output=True, text=True)
    if r.returncode != 0:
        pytest.skip(f"no sanitizer toolchain: {r.stderr[:200]}")
    return so


def test_fuzz_parsers_under_asan(asan_so, corpus):
    root, n = corpus
    env = dict(os.environ)
    env["LD_PRELOAD"] = subprocess.run(["g++", "-print-file-name=libasan.so"],
                                       capture_output=True, text=True).stdout.strip()
    env["ASAN_OPTIONS"] = "detect_leaks=0:abort_on_error=1"
    r = subprocess.run([sys.executable, _HARNESS, asan_so, root], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, f"sanitizer hit:\n{r.stdout[-800:]}\n{r.stderr[-2000:]}"
    assert f"FUZZ-OK n={n}" in r.stdout


def test_corrupt_file_fails_per_item_not_batch(tmp_path, rng):
    """A truncated npy in a batch is an IOError naming that path; the good
    file alone still loads."""
    good = (rng.random((50, 4)) * 100).astype(np.float32)
    gp = tmp_path / "good.npy"
    np.save(gp, good)
    raw = gp.read_bytes()
    bp = tmp_path / "trunc.npy"
    bp.write_bytes(raw[: len(raw) - 40 * 16])     # the header claims 50 rows
    for load in (native.load_batch, native.load_batch_xyp):
        with pytest.raises(IOError, match="trunc.npy"):
            load([str(gp), str(bp)], [0.0, 0.0], cap=64, num_threads=1)
    ev, nv, mx = native.load_batch([str(gp)], [0.0], cap=64, num_threads=1)
    assert nv[0] == 50 and list(mx[0]) == [int(good[:, 0].max()) + 1,
                                           int(good[:, 1].max()) + 1]
    np.testing.assert_array_equal(ev[0, :50], good)
    np.testing.assert_array_equal(ev[0, 50:], 0)


def _outcome(load, path, frac, cap, valid_only):
    """The arrays a loader returns for one file, or the error it raises."""
    try:
        out = load([path], [frac], cap=cap, num_threads=1)
    except IOError as e:
        return ("raised", str(e))
    if valid_only:   # np.empty outputs: only the first n_valid rows are written
        ev, nv = out[0], out[1]
        out = (ev[:, : int(nv[0])], *out[1:])
    return tuple(np.asarray(a) for a in out)


@pytest.mark.parametrize("name,valid_only", [("load_batch", False), ("load_batch_xyp", False),
                                             ("load_batch_imgnet", True),
                                             ("load_batch_dsec", True)])
def test_loaders_agree_with_the_jax_package_over_the_corpus(name, valid_only, corpus):
    """Every corpus file at caps 1 and 64 and slice fractions 0, 0.5 and 1:
    the same arrays (dtype and values), or an IOError on both sides."""
    root, n = corpus
    port, ref = getattr(native, name), getattr(ref_native, name)
    raised = 0
    for f in sorted(os.listdir(root)):
        path = os.path.join(root, f)
        for cap in (1, 64):
            for frac in (0.0, 0.5, 1.0):
                got = _outcome(port, path, frac, cap, valid_only)
                want = _outcome(ref, path, frac, cap, valid_only)
                failed = isinstance(got[0], str)
                assert failed == isinstance(want[0], str), (f, cap, frac, got[:1], want[:1])
                if failed:
                    assert got == want, (f, cap, frac)
                    raised += 1
                    continue
                for a, b in zip(got, want):
                    assert a.dtype == b.dtype, (f, cap, frac)
                    np.testing.assert_array_equal(a, b, err_msg=f"{name} {f} {cap} {frac}")
    assert 0 < raised < n * 6   # some files fail, some load


def test_decoders_agree_with_the_jax_package_over_the_corpus(corpus):
    """The raw ATIS and N-Cars decoders on every corpus file's bytes."""
    root, _ = corpus
    for f in sorted(os.listdir(root)):
        with open(os.path.join(root, f), "rb") as fh:
            buf = fh.read()
        for name in ("decode_atis", "decode_ncars"):
            got, want = getattr(native, name)(buf), getattr(ref_native, name)(buf)
            assert (got is None) == (want is None), (f, name)
            if got is not None:
                np.testing.assert_array_equal(got, want, err_msg=f"{name} {f}")
