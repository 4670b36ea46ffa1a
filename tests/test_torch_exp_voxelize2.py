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
    lambda c, y: X.exp_voxelize2_tiled(c, y, 4, 4, 64, 96),
    lambda c, y: X.exp_voxelize2_tiled(c.long(), y.long(), 4, 4, 64, 1024),
    lambda c, y: X.exp_voxelize2_fused_i8(c, y[:, :32], 4, 4, chunk=64),
    lambda c, y: X.e2e_sort_tiled(c, y, 4, 2048, 64, 1024),
], ids=["i8_chunk_not_32", "i8_chunk_16_not_32", "i8_chunk_smem", "tiled_chunk_not_16",
        "tiled_i8_chunk_not_32", "th_not_32", "th_zero", "tiled_chunk_not_64", "int64",
        "shapes", "e2e_key_too_narrow"])
def test_bad_arguments_raise(call):
    """A chunk that is no multiple of a one-hot K-block (64 events in bf16,
    128 in int8), an X2a chunk (its ring stage) whose two stages overflow a
    block's shared memory, a TH that is no positive multiple of 32, events
    that are not int32 or not of one shape, and a 2W that the packed key
    cannot hold raise ValueError, on the CPU too."""
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
            X.exp_voxelize2_fused_i8(z, z, 4, 4, 128)
        else:
            getattr(X, f"exp_voxelize2_{variant}")(z, z, 4, 4, 32, 128)


@pytest.mark.parametrize("argv", [[], ["all"], ["main3"], ["tiles"]])
def test_main_exits_nonzero_without_a_card(monkeypatch, capsys, argv):
    """The experiment runs on the card only: without one it says so and
    returns 2, printing no timing; an unknown part returns 2 as well."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert X.main(argv) == 2
    out = capsys.readouterr()
    assert "no CUDA device" in out.err and "==" not in out.out
    assert X.main(["main4"]) == 2


def test_reference_sweeps_are_accepted(rng):
    """Every chunk of X2a and (TH, chunk) of X2b / X2c in the reference's
    sweeps (main, main2, main3 and both e2e runs; X2b's chunk 8192 included)
    passes the wrappers' rules, and its plan's stages and rings fit a block."""
    B, N, H, W = 2, 900, 40, 11
    col, ys = X.make_inputs(B, N, H, W, True, "cpu")
    for chunk in (X.MAIN_DENSE_CHUNK, *X.CLS_DENSE_CHUNKS):
        p = X.x2_plan(*X.SEG[:1], *X.SEG[2:], None, chunk)
        assert p.stage == chunk and X.x2_smem(p.tile_n, p.stage) <= X.MAX_SMEM_BYTES
        assert torch.equal(X.exp_voxelize2_fused_i8(col, ys, H, W, chunk),
                           X.exp_voxelize2_fused_i8_reference(col, ys, H, W))
    specs = X.MAIN_TILED + X.MAIN2_TILED + (X.MAIN_E2E, X.MAIN2_E2E)
    assert ("bf16", 128, 8192) in specs
    for dt, TH, chunk in specs:
        for tile_n in X.X2_TILE_NS:
            p = X.x2_plan(*X.SEG[:1], *X.SEG[2:], TH, chunk)
            assert p.stage == min(chunk, X.X2_STAGE_CAP) and p.stage % X.X2_DEPTH[dt] == 0
            assert X.x2_smem(tile_n, p.stage) <= X.MAX_SMEM_BYTES
        fn = X.exp_voxelize2_tiled_i8 if dt == "i8" else X.exp_voxelize2_tiled
        want = X.exp_voxelize2_tiled_reference(col, ys, H, W, TH,
                                               torch.int32 if dt == "i8" else torch.float32)
        assert torch.equal(fn(col, ys, H, W, TH, chunk), want)


def test_dense_stage_limit_is_the_shared_memory():
    """X2a's largest stage is the last multiple of the 128-event K-block
    whose two stages, with the int8 rings of the widest tile (N = 128), fit
    the 232,448 bytes one H100 block may use: 4096 (the reference's largest
    chunk)."""
    widest = max(X.X2_TILE_NS)
    assert X.x2_smem(widest, 4096) <= X.MAX_SMEM_BYTES < X.x2_smem(widest, 4224)
    z = torch.zeros(1, 8, dtype=torch.int32)
    X.exp_voxelize2_fused_i8(z, z, 4, 4, 4096)
    with pytest.raises(ValueError):
        X.exp_voxelize2_fused_i8(z, z, 4, 4, 4224)


def _cover(plan, rows, W):
    """(B, rows, 2W) count of the blocks of ``plan`` that write each cell and
    the number of cells each block owns: block (bx, by, bz) owns rows
    64 by + [0, 64) and columns 2N bx + [0, 2N) of sample bz, clipped to the
    plane."""
    gx, gy, gz = plan.grid
    cover = np.zeros((gz, rows, 2 * W), np.int32)
    cells = []
    for bz in range(gz):
        for by in range(gy):
            for bx in range(gx):
                rs = slice(by * X.X2_ROWS, min((by + 1) * X.X2_ROWS, rows))
                cs = slice(bx * 2 * plan.tile_n, min((bx + 1) * 2 * plan.tile_n, 2 * W))
                cover[bz, rs, cs] += 1
                cells.append(max(rs.stop - rs.start, 0) * max(cs.stop - cs.start, 0))
    return cover, cells


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("shape,TH,chunk", [
    (X.SEG, None, 2048), (X.CLS, None, 4096), (X.SEG, 32, 2048), (X.SEG, 64, 1024),
    (X.SEG, 128, 8192), (X.SEG, 96, 4096), ((3, 100, 37, 45), 32, 128),
    ((2, 100, 129, 97), None, 2048), ((16, 100, 65, 385), 64, 256), ((1, 10, 1, 1), 32, 64)])
def test_x2_plan_covers_every_cell_once(shape, TH, chunk, sms):
    """Every cell of the (B, rows, 2W) planes lies in exactly one block's
    tile (each written once, from registers: no fill, no atomics), no block
    is empty, the waves are the blocks over the SMs, the tile is one of the
    kernel's widths and the stage the chunk's (tiled: at most
    X2_STAGE_CAP)."""
    B, _, H, W = shape
    p = X.x2_plan(B, H, W, TH, chunk, sms)
    rows = H if TH is None else X.n_rows(H, TH)
    cover, cells = _cover(p, rows, W)
    assert (cover == 1).all() and min(cells) > 0
    assert p.grid[2] == B and p.blocks == len(cells) and p.waves == -(-p.blocks // sms)
    assert p.tile_n in X.X2_TILE_NS and p.sms == sms
    assert p.stage == (chunk if TH is None else min(chunk, X.X2_STAGE_CAP))


@pytest.mark.parametrize("shape,TH,want", [
    (X.SEG, None, (96, (7, 7, 8), 392, 3)), (X.CLS, None, (128, (2, 4, 64), 512, 4)),
    (X.SEG, 32, (96, (7, 7, 8), 392, 3)), (X.SEG, 128, (128, (5, 8, 8), 320, 3))])
def test_x2_plan_at_the_reference_shapes(shape, TH, want):
    """On the H100's 132 SMs X2 takes X1's tiles: at seg (8, 440 x 1280) N =
    96, 392 blocks in 3 waves; at cls (64, 256 x 512) N = 128, 512 in 4; the
    tiled kernels at TH 32 (448 rows) as seg, at TH 128 (512 rows) N = 128,
    320 blocks in 3 waves (N = 96 would take 448 in 4)."""
    B, _, H, W = shape
    p = X.x2_plan(B, H, W, TH)
    assert (p.tile_n, p.grid, p.blocks, p.waves) == want


def test_x2_plan_refuses_empty_shapes():
    """No batch, canvas, band or SM: nothing to plan."""
    for args in ((0, 4, 4), (1, 0, 4), (1, 4, 0), (1, 4, 4, 0)):
        with pytest.raises(ValueError):
            X.x2_plan(*args)
    with pytest.raises(ValueError):
        X.x2_plan(1, 4, 4, None, 2048, 0)


def _holds(ys, rows, TH, chunk, tile_rows):
    """(B, tiles, n_chunks) bool, plain numpy: the chunk holds an event whose
    y lies in the tile's rows [tile_rows t, tile_rows (t + 1)) within
    [0, rows)."""
    B, N = ys.shape
    nt, nc = -(-rows // tile_rows), -(-N // chunk)
    out = np.zeros((B, nt, nc), bool)
    for c in range(nc):
        y = ys[:, c * chunk:(c + 1) * chunk]
        for t in range(nt):
            lo, hi = t * tile_rows, min((t + 1) * tile_rows, rows)
            out[:, t, c] = ((y >= lo) & (y < hi)).any(1)
    return out


def _reference_pairs(ys, rows, TH, chunk):
    """(B, bands, n_chunks) bool, plain numpy: the reference's test per band
    and chunk, max(ys) >= t TH and min(ys) < (t + 1) TH over the chunk's own
    events."""
    B, N = ys.shape
    nc = -(-N // chunk)
    out = np.zeros((B, rows // TH, nc), bool)
    for c in range(nc):
        y = ys[:, c * chunk:(c + 1) * chunk]
        for t in range(rows // TH):
            out[:, t, c] = (y.max(1) >= t * TH) & (y.min(1) < (t + 1) * TH)
    return out


@pytest.mark.parametrize("order", ["sorted", "unsorted", "stray"])
@pytest.mark.parametrize("TH,chunk", [(32, 128), (64, 256), (128, 128), (96, 384)])
def test_kept_pairs_are_exact_and_the_reference_s(rng, order, TH, chunk):
    """The (tile, chunk) pairs the kernel consumes, from the bounds table:
    the bounds equal each chunk's min and max; the pairs hold every (tile,
    chunk) whose chunk has an event in the tile's rows (the skip is exact);
    with tiles of TH rows they are the reference's kept (band, chunk) pairs,
    and with the kernel's 64-row tiles each tile's pairs are the union of the
    reference's over the bands it spans (the reference's own at TH = 64). On
    y-sorted, unsorted and stray-y events (negatives, past the rows, a ragged
    last chunk)."""
    B, N, H, W = 3, 1000, 150, 8
    rows = X.n_rows(H, TH)
    col, ys = _events(rng, B, N, H, W, rows, "unsorted" if order == "stray" else order)
    if order != "stray":
        ys = np.clip(ys, 0, rows - 1)
        if order == "sorted":
            ys = np.sort(ys, axis=1)
    bounds = X.chunk_bounds(torch.from_numpy(ys), chunk)
    nc = -(-N // chunk)
    assert bounds.shape == (B, nc, 2) and bounds.dtype == torch.int32
    for c in range(nc):
        y = ys[:, c * chunk:(c + 1) * chunk]
        np.testing.assert_array_equal(bounds[:, c].numpy(), np.stack([y.min(1), y.max(1)], 1))
    ref = _reference_pairs(ys, rows, TH, chunk)
    band = X.kept_pairs(bounds, rows, TH, TH).numpy()
    np.testing.assert_array_equal(band, ref)
    tiles = X.kept_pairs(bounds, rows, TH, X.X2_ROWS).numpy()
    for kept, tile_rows in ((band, TH), (tiles, X.X2_ROWS)):
        holds = _holds(ys, rows, TH, chunk, tile_rows)
        assert (kept | ~holds).all() and holds.any()
    for t in range(tiles.shape[1]):
        r0, r1 = t * X.X2_ROWS, min((t + 1) * X.X2_ROWS, rows)
        spanned = range(r0 // TH, -(-r1 // TH))
        np.testing.assert_array_equal(tiles[:, t], ref[:, list(spanned)].any(1))


def test_c_entries_match_the_ctypes_signatures():
    """Every extern "C" entry point of csrc/*.cu takes as many parameters as
    build.SIGNATURES binds (ctypes would pass a short or long argument list
    on without a word), X2's three among them."""
    import re

    from mem_tpu_torch.kernels import build

    found = {}
    for src in build.sources():
        for name, params in re.findall(r'extern "C"[^(]*?\b(mem_\w+)\s*\(([^)]*)\)',
                                       src.read_text()):
            params = params.strip()
            found[name] = 0 if params in ("", "void") else params.count(",") + 1
    for name in ("mem_exp_voxelize2_fused_i8", "mem_exp_voxelize2_tiled",
                 "mem_exp_voxelize2_tiled_i8"):
        assert name in found
    assert set(found) == set(build.SIGNATURES)
    for name, count in found.items():
        assert len(build.SIGNATURES[name][0]) == count, name
