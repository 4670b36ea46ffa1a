"""The voxelizer experiment X2 (mem_tpu_torch/tools/exp_voxelize2.py): the
port's plain versions of X2a, X2b and X2c held against the reference's own
Pallas bodies (scripts/exp_voxelize2.py) run in interpret mode with its block
specs and its sentinel padding, on the same numpy inputs, on the uncropped
(B, n_tiles * TH, 2W) output: y-sorted and unsorted events, with negative
coordinates, the sentinels (col 2W, ys H and n_tiles * TH + 1), values past
them and ys in [H, n_tiles * TH). Stated tolerance: 0 (integer counts; in
f32 exact below 2^24). The whole slice, the packed-key sort and the tiled
kernel, is held against the reference's ``e2e`` composition."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mem_tpu_torch.tools import exp_voxelize2 as X
from test_torch_exp_voxelize import _import_reference

REF = _import_reference("scripts.exp_voxelize2")
BGROUP = 2


def _pad(a, B, N, chunk, value):
    """Pad samples to a multiple of the block group and events to a multiple
    of the chunk with ``value``, as the script pads (exp_voxelize2.py:125-127,
    148-151)."""
    return np.pad(a, ((0, (-B) % BGROUP), (0, (-N) % chunk)), constant_values=value)


def _call(kernel, grid, block_rows, out_rows, W, dtype, col, ys):
    """``kernel`` through pl.pallas_call with the script's specs, interpret
    mode; (Bp, out_rows, 2W) as numpy."""
    Bp = col.shape[0]
    if len(grid) == 2:   # dense: grid (b, c)
        ev = pl.BlockSpec((BGROUP, col.shape[1] // grid[1]), lambda b, c: (b, c),
                          memory_space=pltpu.VMEM)
        out = pl.BlockSpec((BGROUP, block_rows, 2 * W), lambda b, c: (b, 0, 0),
                           memory_space=pltpu.VMEM)
    else:                # tiled: grid (b, t, c)
        ev = pl.BlockSpec((BGROUP, col.shape[1] // grid[2]), lambda b, t, c: (b, c),
                          memory_space=pltpu.VMEM)
        out = pl.BlockSpec((BGROUP, block_rows, 2 * W), lambda b, t, c: (b, t, 0),
                           memory_space=pltpu.VMEM)
    call = pl.pallas_call(kernel, grid=grid, in_specs=[ev] * 2, out_specs=out,
                          out_shape=jax.ShapeDtypeStruct((Bp, out_rows, 2 * W), dtype),
                          interpret=True)
    return np.asarray(call(jnp.asarray(col), jnp.asarray(ys)))


def _dense_reference(col, ys, H, W, chunk):
    """_kernel_fused_i8 as main builds it (exp_voxelize2.py:124-142): col
    padded with 2W, ys with H."""
    B, N = col.shape
    colp, ysp = _pad(col, B, N, chunk, 2 * W), _pad(ys, B, N, chunk, H)
    kernel = functools.partial(REF._kernel_fused_i8, H=H, W=W, chunk=chunk, bgroup=BGROUP)
    grid = (colp.shape[0] // BGROUP, colp.shape[1] // chunk)
    return _call(kernel, grid, H, H, W, jnp.int32, colp, ysp)[:B]


def _tiled_reference(col, ys, H, W, TH, chunk, int8):
    """_kernel_tiled / _kernel_tiled_i8 as main and main2 build them
    (exp_voxelize2.py:144-170, 212-232): col padded with 2W, ys with
    n_tiles * TH + 1; the uncropped (B, n_tiles * TH, 2W) output."""
    B, N = col.shape
    n_tiles = -(-H // TH)
    colp, ysp = _pad(col, B, N, chunk, 2 * W), _pad(ys, B, N, chunk, n_tiles * TH + 1)
    body = REF._kernel_tiled_i8 if int8 else REF._kernel_tiled
    kernel = functools.partial(body, TH=TH, W=W, chunk=chunk, bgroup=BGROUP)
    grid = (colp.shape[0] // BGROUP, n_tiles, colp.shape[1] // chunk)
    return _call(kernel, grid, TH, n_tiles * TH, W, jnp.int32 if int8 else jnp.float32,
                 colp, ysp)[:B]


def _events(rng, B, N, H, W, rows, order):
    """col in [-2, 2W + 3) and ys in [-2, rows + 3): negatives, ys in
    [H, rows), values past the sentinels, and blocks of the sentinels (col
    2W, ys H, ys rows + 1); y-sorted per sample (stable) for "sorted"."""
    col = rng.integers(-2, 2 * W + 3, (B, N)).astype(np.int32)
    ys = rng.integers(-2, rows + 3, (B, N)).astype(np.int32)
    col[:, :30] = 2 * W
    ys[:, 30:60] = H
    ys[:, 60:80] = rows + 1
    if order == "sorted":
        idx = np.argsort(ys, axis=1, kind="stable")
        col, ys = np.take_along_axis(col, idx, axis=1), np.take_along_axis(ys, idx, axis=1)
    return col, ys


@pytest.mark.parametrize("B,N,H,W,chunk", [(3, 700, 9, 11, 128), (2, 1024, 40, 8, 256)])
def test_fused_i8_reference_matches_pallas_interpret(rng, B, N, H, W, chunk):
    """Plain X2a (K1's plain version, int32) == _kernel_fused_i8 exactly, one
    N not a multiple of the chunk; the CPU wrapper takes the plain version."""
    col, ys = _events(rng, B, N, H, W, H, "unsorted")
    want = _dense_reference(col, ys, H, W, chunk)
    tc, ty = torch.from_numpy(col), torch.from_numpy(ys)
    got = X.exp_voxelize2_fused_i8_reference(tc, ty, H, W)
    assert got.dtype == torch.int32 and got.shape == (B, H, 2 * W)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0
    assert torch.equal(X.exp_voxelize2_fused_i8(tc, ty, H, W, chunk), got)


@pytest.mark.parametrize("order", ["sorted", "unsorted"])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "i8"])
@pytest.mark.parametrize("B,N,H,W,TH,chunk", [(3, 700, 40, 11, 16, 128),
                                              (2, 900, 37, 8, 8, 256)])
def test_tiled_reference_matches_pallas_interpret(rng, order, int8, B, N, H, W, TH, chunk):
    """Plain X2b (f32) / X2c (int32) == _kernel_tiled / _kernel_tiled_i8
    exactly on the uncropped output, rows H <= y < n_tiles * TH included, on
    sorted and unsorted events (the skip is exact for any order)."""
    rows = X.n_rows(H, TH)
    assert rows > H
    col, ys = _events(rng, B, N, H, W, rows, order)
    want = _tiled_reference(col, ys, H, W, TH, chunk, int8)
    got = X.exp_voxelize2_tiled_reference(torch.from_numpy(col), torch.from_numpy(ys), H, W, TH,
                                          torch.int32 if int8 else torch.float32)
    assert got.shape == (B, rows, 2 * W)
    assert got.dtype == (torch.int32 if int8 else torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[:, H:].sum() > 0   # the rows past H count


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "i8"])
def test_tiled_wrappers_take_the_plain_version_on_cpu(rng, int8):
    """The CPU wrappers (TH a multiple of 32) return their plain versions,
    f32 / int32 over n_tiles * TH rows, and the crop [:, :H] of valid events
    is K1's plain histogram."""
    B, N, H, W, TH = 3, 2000, 40, 11, 32
    col, ys = (torch.from_numpy(a) for a in _events(rng, B, N, H, W, 64, "sorted"))
    fn = X.exp_voxelize2_tiled_i8 if int8 else X.exp_voxelize2_tiled
    dt = torch.int32 if int8 else torch.float32
    got = fn(col, ys, H, W, TH, 256)
    assert torch.equal(got, X.exp_voxelize2_tiled_reference(col, ys, H, W, TH, dt))
    assert got.shape == (B, 64, 2 * W)
    c, y = X.make_inputs(B, N, H, W, True, "cpu")
    planes = fn(c, y, H, W, TH, 256)
    assert torch.equal(planes[:, :H].to(torch.int32), X.exp_voxelize2_fused_i8_reference(
        c, y, H, W))
    assert planes[:, H:].sum() == 0 and planes.sum() == B * N


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "i8"])
def test_e2e_sort_tiled_matches_the_script_s_e2e(rng, int8):
    """The whole slice: ``e2e_sort_tiled`` == the reference's ``e2e``
    (exp_voxelize2.py:186-195, 261-268): jnp.sort of the packed key, split by
    // and %, padded, then the body in interpret mode; on unsorted events
    with stray coordinates, which the key's split moves alike in both."""
    B, N, H, W, TH, chunk = 3, 700, 40, 11, 32, 128
    col, ys = _events(rng, B, N, H, W, X.n_rows(H, TH), "unsorted")
    k = np.asarray(jnp.sort(jnp.asarray(ys) * 4096 + jnp.asarray(col), axis=1))
    want = _tiled_reference(np.asarray(k % 4096, np.int32), np.asarray(k // 4096, np.int32),
                            H, W, TH, chunk, int8)
    got = X.e2e_sort_tiled(torch.from_numpy(col), torch.from_numpy(ys), H, W, TH, chunk, int8)
    assert got.dtype == (torch.int32 if int8 else torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sort_packed_matches_jnp_sort(rng):
    """The packed-key sort: torch.sort of ys * 4096 + col split by floor
    division and modulo == the reference's jnp.sort and // / % (negative
    and out-of-range coordinates included)."""
    col, ys = _events(rng, 3, 500, 20, 11, 32, "unsorted")
    k = jnp.sort(jnp.asarray(ys) * 4096 + jnp.asarray(col), axis=1)
    c, y = X.sort_packed(torch.from_numpy(col), torch.from_numpy(ys))
    np.testing.assert_array_equal(c.numpy(), np.asarray(k % 4096))
    np.testing.assert_array_equal(y.numpy(), np.asarray(k // 4096))
    assert c.dtype == y.dtype == torch.int32


@pytest.mark.parametrize("sort", [False, True])
def test_make_inputs_are_the_script_s(monkeypatch, sort):
    """make_inputs draws the reference's events (its B, N, H, W are module
    globals, set small here)."""
    B, N, H, W = 2, 3000, 12, 10
    for name, v in (("B", B), ("N", N), ("H", H), ("W", W)):
        monkeypatch.setattr(REF, name, v)
    col, ys, _ = REF.make_inputs(sort=sort)
    c, y = X.make_inputs(B, N, H, W, sort, "cpu")
    np.testing.assert_array_equal(c.numpy(), np.asarray(col))
    np.testing.assert_array_equal(y.numpy(), np.asarray(ys))


@pytest.mark.parametrize("call", [
    lambda c, y: X.exp_voxelize2_fused_i8(c, y, 4, 4, chunk=2000),
    lambda c, y: X.exp_voxelize2_fused_i8(c, y, 4, 4, chunk=48),
    lambda c, y: X.exp_voxelize2_fused_i8(c, y, 4, 4, chunk=32768),
    lambda c, y: X.exp_voxelize2_tiled(c, y, 4, 4, 32, 1000),
    lambda c, y: X.exp_voxelize2_tiled_i8(c, y, 4, 4, 32, 1040),
    lambda c, y: X.exp_voxelize2_tiled(c, y, 4, 4, 48, 1024),
    lambda c, y: X.exp_voxelize2_tiled_i8(c, y, 4, 4, 0, 1024),
    lambda c, y: X.exp_voxelize2_tiled(c, y, 4, 4, 64, 32768),
    lambda c, y: X.exp_voxelize2_tiled(c.long(), y.long(), 4, 4, 64, 1024),
    lambda c, y: X.exp_voxelize2_fused_i8(c, y[:, :32], 4, 4, chunk=64),
    lambda c, y: X.e2e_sort_tiled(c, y, 4, 2048, 64, 1024),
], ids=["i8_chunk_not_32", "i8_chunk_16_not_32", "i8_chunk_smem", "tiled_chunk_not_16",
        "tiled_i8_chunk_not_32", "th_not_32", "th_zero", "tiled_chunk_smem", "int64",
        "shapes", "e2e_key_too_narrow"])
def test_bad_arguments_raise(call):
    """A chunk that is no multiple of the k-step (16 in bf16, 32 in int8) or
    overflows a block's shared memory, a TH that is no positive multiple of
    32, events that are not int32 or not of one shape, and a 2W that the
    packed key cannot hold raise ValueError, on the CPU too."""
    z = torch.zeros(2, 64, dtype=torch.int32)
    with pytest.raises(ValueError):
        call(z, z)


@pytest.mark.parametrize("variant", ["fused_i8", "tiled", "tiled_i8"])
def test_non_cuda_device_raises(variant):
    """A tensor on neither the CPU nor a CUDA device never reaches a plain
    version or a kernel."""
    z = torch.zeros(2, 64, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        if variant == "fused_i8":
            X.exp_voxelize2_fused_i8(z, z, 4, 4, 64)
        else:
            getattr(X, f"exp_voxelize2_{variant}")(z, z, 4, 4, 32, 64)


@pytest.mark.parametrize("argv", [[], ["all"], ["main3"]])
def test_main_exits_nonzero_without_a_card(monkeypatch, capsys, argv):
    """The experiment runs on the card only: without one it says so and
    returns 2, printing no timing; an unknown part returns 2 as well."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert X.main(argv) == 2
    out = capsys.readouterr()
    assert "no CUDA device" in out.err and "==" not in out.out
    assert X.main(["main4"]) == 2
