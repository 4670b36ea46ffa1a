"""The voxelizer experiment X1 (mem_tpu_torch/tools/exp_voxelize.py): the
port's plain versions of X1a, X1b and X1c held against the reference's own
Pallas bodies (scripts/exp_voxelize.py) run in interpret mode with
``run_variant``'s block specs, on the same numpy inputs with out-of-range
and sentinel coordinates mixed in. Counts are exact; X1a is exact on dyadic
weights and within 1e-6 relative L2 on random ones (f32 sums in another
order)."""
import functools
import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mem_tpu_torch.tools import exp_voxelize as X


def _import_reference(name):
    """Import a reference script from this checkout, undoing its
    process-wide edits (it points jax's compilation cache at a TPU directory
    and prepends a fixed path to sys.path). The reference package, then the
    scripts' shared module, then the script are each imported on this
    checkout's sys.path, restored after each, so every import a script makes
    resolves from sys.modules and the prepended path is never searched."""
    cache, path = jax.config.jax_compilation_cache_dir, list(sys.path)
    for module in ("mem_tpu.ops.attention", "scripts.trace_pretrain", name):
        try:
            importlib.import_module(module)
        finally:
            jax.config.update("jax_compilation_cache_dir", cache)
            sys.path[:] = path
    return sys.modules[name]


REF = _import_reference("scripts.exp_voxelize")


def _run_reference(kernel, arrays, B, H, W, chunk, bgroup, **kw):
    """The body through ``pl.pallas_call`` as run_variant builds it
    (exp_voxelize.py:98-130), padded as it pads (xs 0, ys H, pol 0), in
    interpret mode; the padded samples are dropped."""
    pad = ((0, (-B) % bgroup), (0, (-arrays[0][0].shape[1]) % chunk))
    arrays = [np.pad(a, pad, constant_values=v) for a, v in arrays]
    Bp, Np = arrays[0].shape
    ev_spec = pl.BlockSpec((bgroup, chunk), lambda b, c: (b, c), memory_space=pltpu.VMEM)
    out_spec = pl.BlockSpec((bgroup, H, 2 * W), lambda b, c: (b, 0, 0),
                            memory_space=pltpu.VMEM)
    call = pl.pallas_call(
        functools.partial(kernel, H=H, W=W, chunk=chunk, bgroup=bgroup, **kw),
        grid=(Bp // bgroup, Np // chunk), in_specs=[ev_spec] * len(arrays),
        out_specs=out_spec, out_shape=jax.ShapeDtypeStruct((Bp, H, 2 * W), jnp.float32),
        interpret=True)
    return np.asarray(call(*map(jnp.asarray, arrays)))[:B]


def _coords(rng, B, N, H, W, hi):
    """x (or col) in [-2, hi + 3) and y in [-2, H + 3): negatives and values
    past the sentinels, plus a block of sentinels (hi, H)."""
    a = rng.integers(-2, hi + 3, (B, N)).astype(np.int32)
    ys = rng.integers(-2, H + 3, (B, N)).astype(np.int32)
    a[:, :40] = hi
    ys[:, 40:80] = H
    return a, ys


@pytest.mark.parametrize("weights", ["dyadic", "random"])
def test_base_reference_matches_pallas_interpret(rng, weights):
    """Plain X1a == _kernel_base: exactly on weights in {0, 1/4, 1/2, 1}, and
    within 1e-6 relative L2 on random f32 weights (a plain version without
    the bf16 rounding of the weights is ~1e-3 off); the CPU wrapper takes
    the plain version."""
    B, N, H, W = 3, 700, 9, 11
    xs, ys = _coords(rng, B, N, H, W, W)
    if weights == "dyadic":
        wpos, wneg = (rng.choice([0.0, 0.25, 0.5, 1.0], (B, N)).astype(np.float32)
                      for _ in range(2))
    else:
        wpos, wneg = (rng.standard_normal((B, N)).astype(np.float32) for _ in range(2))
    want = _run_reference(REF._kernel_base, [(xs, 0), (ys, H), (wpos, 0.0), (wneg, 0.0)],
                          B, H, W, chunk=256, bgroup=2)
    t = [torch.from_numpy(a) for a in (xs, ys, wpos, wneg)]
    got = X.exp_voxelize_base_reference(*t, H, W)
    assert got.dtype == torch.float32 and got.shape == (B, H, 2 * W)
    if weights == "dyadic":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert rel <= 1e-6, rel
    assert torch.equal(X.exp_voxelize_base(*t, H, W, chunk=256), got)


@pytest.mark.parametrize("variant", ["fused", "loop"])
@pytest.mark.parametrize("B,N,H,W,chunk", [(3, 700, 9, 11, 256), (2, 1024, 16, 8, 512)])
def test_fused_reference_matches_pallas_interpret(rng, variant, B, N, H, W, chunk):
    """Plain X1b / X1c (K1's plain version as f32) == _kernel_fused_onehot /
    _kernel_fused_loop exactly, one N not a multiple of the chunk; the CPU
    wrappers take the plain version."""
    col, ys = _coords(rng, B, N, H, W, 2 * W)
    if variant == "fused":
        kernel, kw = REF._kernel_fused_onehot, {}
        wrapper = functools.partial(X.exp_voxelize_fused_onehot, chunk=chunk)
    else:
        kernel, kw = REF._kernel_fused_loop, {"inner": chunk // 4}
        wrapper = functools.partial(X.exp_voxelize_fused_loop, chunk=chunk, inner=chunk // 4)
    want = _run_reference(kernel, [(col, 2 * W), (ys, H)], B, H, W, chunk=chunk, bgroup=2,
                          **kw)
    tc, ty = torch.from_numpy(col), torch.from_numpy(ys)
    got = X.exp_voxelize_fused_reference(tc, ty, H, W)
    assert got.dtype == torch.float32 and got.shape == (B, H, 2 * W)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(wrapper(tc, ty, H, W), got)


def test_base_on_packed_events_equals_fused(rng):
    """The reference's own inputs (make_events): X1a from the raw arrays and
    X1b from pack's col give the same planes, which count every event."""
    xs, ys, wpos, wneg, col, ysp = X.make_events(2, 3000, 12, 10, "cpu")
    base = X.exp_voxelize_base(xs, ys, wpos, wneg, 12, 10)
    assert torch.equal(base, X.exp_voxelize_fused_onehot(col, ysp, 12, 10))
    assert base.sum().item() == 2 * 3000


@pytest.mark.parametrize("call", [
    lambda c, y: X.exp_voxelize_fused_loop(c, y, 4, 4, chunk=8192, inner=3000),
    lambda c, y: X.exp_voxelize_fused_loop(c, y, 4, 4, chunk=1024, inner=0),
    lambda c, y: X.exp_voxelize_fused_onehot(c, y, 4, 4, chunk=1000),
    lambda c, y: X.exp_voxelize_fused_onehot(c, y, 4, 4, chunk=32768),
    lambda c, y: X.exp_voxelize_base(c, y, c.float(), c.float(), 4, 4, chunk=20480),
    lambda c, y: X.exp_voxelize_fused_onehot(c, y, 4, 4, chunk=1040),
    lambda c, y: X.exp_voxelize_fused_onehot(c, y, 4, 4, chunk=4224),
    lambda c, y: X.exp_voxelize_fused_onehot(c, y, 4, 4, chunk=8192),
    lambda c, y: X.exp_voxelize_base(c, y, c.float(), c.float(), 4, 4, chunk=2112),
    lambda c, y: X.exp_voxelize_base(c, y, c.float(), c.float(), 4, 4, chunk=4096),
    lambda c, y: X.exp_voxelize_fused_loop(c, y, 4, 4, chunk=8320, inner=1040),
    lambda c, y: X.exp_voxelize_fused_loop(c, y, 4, 4, chunk=8448, inner=4224),
], ids=["inner_not_dividing", "inner_zero", "chunk_not_16", "chunk_smem", "base_chunk_smem",
        "chunk_not_64", "chunk_past_4160", "chunk_8192", "base_chunk_past_2048",
        "base_chunk_4096", "inner_not_64", "inner_past_4160"])
def test_bad_chunks_raise(call):
    """X1c refuses an ``inner`` that does not divide ``chunk`` (the
    reference would drop each chunk's tail); a chunk (X1c: an inner) that is
    no multiple of the kernel's 64-event slot, or whose two ring stages do
    not fit a block's shared memory beside the one-hot rings (X1b above 4160
    events, X1a with its four arrays above 2048), raises too."""
    z = torch.zeros(2, 64, dtype=torch.int32)
    with pytest.raises(ValueError):
        call(z, z)


def test_reference_sweep_is_accepted(rng):
    """Every chunk of the reference's sweep (X1a 2048; X1b 1024, 2048, 4096;
    X1c 8192 with inner 2048) passes the wrappers' rules, and each is one
    whose two stages fit a block with the widest tile (x1_smem)."""
    xs, ys, wpos, wneg, col, ysp = X.make_events(2, 700, 9, 11, "cpu")
    want = X.exp_voxelize_fused_reference(col, ysp, 9, 11)
    for variant, chunk, inner in X.VARIANTS:
        if variant == "base":
            assert X.x1_smem(4, chunk) <= X.MAX_SMEM_BYTES
            got = X.exp_voxelize_base(xs, ys, wpos, wneg, 9, 11, chunk)
        elif variant == "fused":
            assert X.x1_smem(2, chunk) <= X.MAX_SMEM_BYTES
            got = X.exp_voxelize_fused_onehot(col, ysp, 9, 11, chunk)
        else:
            assert X.x1_smem(2, inner) <= X.MAX_SMEM_BYTES
            got = X.exp_voxelize_fused_loop(col, ysp, 9, 11, chunk, inner)
        assert torch.equal(got, want)


@pytest.mark.parametrize("words,last_ok", [(2, 4160), (4, 2048)])
def test_stage_limit_is_the_shared_memory(words, last_ok):
    """The largest stage accepted is the last multiple of 64 whose two
    stages, with the A / B rings of the widest tile (N = 128), fit the
    232,448 bytes one H100 block may use."""
    assert X.x1_smem(words, last_ok) <= X.MAX_SMEM_BYTES < X.x1_smem(words, last_ok + 64)


def _cover(plan, H, W):
    """(B, H, 2W) count of the blocks of ``plan`` that write each cell: block
    (bx, by, bz) owns rows 64 by + [0, 64) and columns 2N bx + [0, 2N) of
    sample bz, clipped to the plane; the number of cells each block owns."""
    gx, gy, gz = plan.grid
    cover = np.zeros((gz, H, 2 * W), np.int32)
    cells = []
    for bz in range(gz):
        for by in range(gy):
            for bx in range(gx):
                r0, c0 = by * X.X1_ROWS, bx * 2 * plan.tile_n
                rows = slice(r0, min(r0 + X.X1_ROWS, H))
                cols = slice(c0, min(c0 + 2 * plan.tile_n, 2 * W))
                cover[bz, rows, cols] += 1
                cells.append((rows.stop - rows.start) * max(cols.stop - cols.start, 0))
    return cover, cells


@pytest.mark.parametrize("B,H,W,sms", [
    (8, 440, 640, 132), (64, 256, 256, 132), (3, 37, 45, 132), (2, 129, 97, 132),
    (16, 65, 385, 132), (1, 1, 1, 132), (8, 440, 640, 114), (5, 300, 200, 16)])
def test_x1_plan_covers_every_cell_once(B, H, W, sms):
    """Every cell of the (B, H, 2W) planes lies in exactly one block's tile
    (each written once, from registers: no fill, no atomics), no block is
    empty, and the waves are the blocks over the SMs; the tile is one of
    the kernel's widths."""
    p = X.x1_plan(B, H, W, sms)
    cover, cells = _cover(p, H, W)
    assert (cover == 1).all() and min(cells) > 0
    assert p.tile_n in X.X1_TILE_NS and p.grid[2] == B
    assert p.blocks == len(cells) and p.waves == -(-p.blocks // sms) and p.sms == sms


@pytest.mark.parametrize("shape,want", [
    ("seg", (96, (7, 7, 8), 392, 3)), ("cls", (128, (2, 4, 64), 512, 4))])
def test_x1_plan_at_the_reference_shapes(shape, want):
    """On the H100's 132 SMs: at seg (8, 440 x 1280) N = 96 fills the card in
    3 waves of 64 x 192 tiles (N = 128 would take 3 waves of larger tiles);
    at cls (64, 256 x 512) N = 128 takes 4 waves (N = 96 would take 6)."""
    B, _, H, W = X.SHAPES[shape]
    p = X.x1_plan(B, H, W)
    assert (p.tile_n, p.grid, p.blocks, p.waves) == want
    other = [t for t in X.X1_TILE_NS if t != p.tile_n][0]
    blocks = -(-2 * W // (2 * other)) * -(-H // X.X1_ROWS) * B
    assert -(-blocks // 132) * other > p.waves * p.tile_n


def test_x1_plan_refuses_empty_shapes():
    """No batch, canvas or SM: nothing to plan."""
    for args in ((0, 4, 4), (1, 0, 4), (1, 4, 0)):
        with pytest.raises(ValueError):
            X.x1_plan(*args)
    with pytest.raises(ValueError):
        X.x1_plan(1, 4, 4, 0)


@pytest.mark.parametrize("variant", ["base", "fused", "loop"])
def test_non_cuda_device_raises(variant):
    """A tensor on neither the CPU nor a CUDA device never reaches a plain
    version or a kernel."""
    z = torch.zeros(2, 64, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        if variant == "base":
            X.exp_voxelize_base(z, z, z.float(), z.float(), 4, 4)
        elif variant == "fused":
            X.exp_voxelize_fused_onehot(z, z, 4, 4)
        else:
            X.exp_voxelize_fused_loop(z, z, 4, 4)


def test_main_exits_nonzero_without_a_card(monkeypatch, capsys):
    """The experiment runs on the card only: without one it says so and
    returns 2, printing no timing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert X.main(["all"]) == 2
    out = capsys.readouterr()
    assert "no CUDA device" in out.err and "==" not in out.out
