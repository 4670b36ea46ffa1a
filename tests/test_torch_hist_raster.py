"""The raster mode of K1 / K4 and the launch plan of their shared body.

voxelize_raster_reference (the raster mode's plain version: K1's plain
planes, wrapped and stacked) against the JAX package on its Pallas route in
interpret mode, the one branch of voxelize_fused that takes the raster mode,
and hist_plan (rows a block, blocks) at the shapes the model
paths use. Rasters and counts are integers: every comparison is exact."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mem_tpu.ops.voxelize as vx
from mem_tpu.ops.voxelize_pallas import voxelize_pallas
from mem_tpu_torch.ops import voxelize as tvx
from mem_tpu_torch.ops import voxelize_hist as vh


def _events(rng, B, N, H, W, sort_y=False):
    """(B, N, 4) f32 events with coordinates a few pixels past the canvas,
    more than 255 hits on one pixel of sample 0, and (B,) valid counts."""
    ev = np.zeros((B, N, 4), np.float32)
    ev[..., 0] = rng.integers(-3, W + 3, (B, N))
    ev[..., 1] = rng.integers(-3, H + 3, (B, N))
    ev[..., 2] = np.sort(rng.integers(0, 10**6, (B, N)), axis=1)
    ev[..., 3] = rng.choice([-1.0, 1.0], (B, N))
    ev[0, :400, :2] = (5, 7)
    if sort_y:
        ev[..., 1] = np.sort(ev[..., 1], axis=1)
    nv = np.array([N, N - 300, 3, N][:B], np.int32)
    return ev, nv


@pytest.mark.parametrize("wrap_uint8", [True, False])
@pytest.mark.parametrize("B,N,H,W", [(3, 1500, 24, 20), (2, 700, 9, 33)])
def test_raster_reference_matches_pallas_interpret(rng, wrap_uint8, B, N, H, W):
    """voxelize_raster_reference of the packed events == the reference's
    drop-in rasterizer (voxelize_pallas: the dense kernel in interpret mode,
    then wrap or clamp, zeros and stack)."""
    ev, nv = _events(rng, B, N, H, W)
    want = np.asarray(voxelize_pallas(jnp.asarray(ev), jnp.asarray(nv), H, W,
                                      wrap_uint8=wrap_uint8, chunk=512, interpret=True))
    xs = torch.from_numpy(ev[..., 0]).int()
    ys = torch.from_numpy(ev[..., 1]).int()
    ok = ((torch.arange(N)[None] < torch.from_numpy(nv)[:, None])
          & (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H))
    ps = torch.from_numpy(ev[..., 3])
    col, ysf = vh.pack_cols(xs.clamp(0, W - 1), ys.clamp(0, H - 1),
                            (ok & (ps == 1)).float(), (ok & (ps == -1)).float(), H, W)
    got = vh.voxelize_raster_reference(col, ysf, H, W, wrap_uint8)
    assert got.dtype == torch.uint8 and got.shape == (B, H, W, 3)
    np.testing.assert_array_equal(got.numpy(), want)


_AUG = {
    "plain": {},
    "flips_shifts": dict(time_flip=True, x_flip=True, shift=True, sample_hw=True),
}


@pytest.mark.parametrize("aug", sorted(_AUG))
@pytest.mark.parametrize("wrap_uint8", [True, False])
@pytest.mark.parametrize("canvas", ["k1", "k4"])
def test_fused_raster_matches_jax(rng, monkeypatch, aug, wrap_uint8, canvas):
    """The port's voxelize_fused without a time surface, whose raster comes
    from voxelize_raster_reference on the CPU, == mem_tpu's with the Pallas
    histogram forced (K1, or K4 on the DSEC canvas, in interpret mode)."""
    B, N, H, W = (4, 1200, 40, 32) if canvas == "k1" else (2, 3000, 440, 640)
    ev, nv = _events(rng, B, N, H, W, sort_y=canvas == "k4")
    opts = _AUG[aug]
    kw = {}
    if opts.get("time_flip"):
        kw["time_flip"] = rng.random(B) < 0.5
    if opts.get("x_flip"):
        kw["x_flip"] = rng.random(B) < 0.5
    if opts.get("shift"):
        kw["shift_xy"] = rng.integers(-3, 4, (B, 2)).astype(np.int32)
    if opts.get("sample_hw"):
        kw["sample_H"] = rng.integers(H - 8, H + 1, B).astype(np.int32)
        kw["sample_W"] = rng.integers(W - 8, W + 1, B).astype(np.int32)
    monkeypatch.setattr(vx, "PALLAS_HIST", True)
    want = np.asarray(vx.voxelize_fused(jnp.asarray(ev), jnp.asarray(nv), H, W,
                                        wrap_uint8=wrap_uint8,
                                        **{k: jnp.asarray(v) for k, v in kw.items()}))
    calls = []
    real = vh.voxelize_raster_reference

    def spy(*a, **k):
        calls.append(a[2:4])
        return real(*a, **k)

    monkeypatch.setattr(vh, "voxelize_raster_reference", spy)
    got = tvx.voxelize_fused(torch.from_numpy(ev), torch.from_numpy(nv), H, W,
                             wrap_uint8=wrap_uint8, **{k: torch.from_numpy(v)
                                                       for k, v in kw.items()})
    if canvas == "k1":
        assert calls == [(H, W)]
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("time_surface,n_bins,raster", [
    (False, 0, True), (True, 0, False), (False, 2, False)])
@pytest.mark.parametrize("H,W", [(16, 16), (440, 640)])
def test_fused_takes_raster_mode_exactly_without_surface_and_bins(
        monkeypatch, time_surface, n_bins, raster, H, W):
    """voxelize_fused asks voxelize_planes for the raster exactly when
    time_surface is False and n_bins is 0, and that raster is the planes ->
    wrap -> stack chain of the same events, to the bit."""
    seen, chains = [], []
    real = tvx.voxelize_planes

    def spy(*a, **kw):
        seen.append(kw.get("raster", False))
        if seen[-1]:
            planes = real(*a, **{k: v for k, v in kw.items() if k not in ("raster", "wrap_uint8")})
            chains.append(vh.raster_from_planes(planes, kw.get("wrap_uint8", True)))
        return real(*a, **kw)

    monkeypatch.setattr(tvx, "voxelize_planes", spy)
    ev = torch.zeros(2, 300, 4)
    ev[..., 0] = torch.arange(300.0) % W
    ev[..., 1] = torch.arange(300.0) % H
    ev[..., 2] = torch.arange(300.0)
    ev[..., 3] = 1.0 - 2.0 * (torch.arange(300) % 3 == 0).float()
    nv = torch.tensor([300, 111])
    got = tvx.voxelize_fused(ev, nv, H, W, time_surface=time_surface, n_bins=n_bins)
    assert seen == [raster]
    if raster:
        assert len(chains) == 1 and torch.equal(got, chains[0])


@pytest.mark.parametrize("wrap_uint8", [True, False])
@pytest.mark.parametrize("presorted", [False, True])
def test_cpu_wrappers_raster(rng, wrap_uint8, presorted):
    """On CPU tensors both wrappers' raster mode is the plain version: the
    (B, H, W, 3) uint8 [pos, 0, neg], counts past 255 wrapped or clamped."""
    B, N, H, W = 2, 2500, 30, 20
    col = torch.from_numpy(rng.integers(-2, 2 * W + 3, (B, N)).astype(np.int32))
    ys = torch.from_numpy(rng.integers(-2, H + 3, (B, N)).astype(np.int32))
    col[0, :600], ys[0, :600] = W + 4, 6          # 600 negative events on one pixel
    want = vh.voxelize_raster_reference(col, ys, H, W, wrap_uint8)
    assert int(want[0, 6, 4, 2]) == (600 % 256 if wrap_uint8 else 255)
    assert int(want[..., 1].abs().sum()) == 0
    assert torch.equal(vh.hist_planes_cols(col, ys, H, W, raster=True, wrap_uint8=wrap_uint8),
                       want)
    if presorted:
        col, ys = vh.sort_events_by_row(col, ys, H)
    assert torch.equal(vh.hist_planes_cols_sorted(col, ys, H, W, presorted=presorted,
                                                  raster=True, wrap_uint8=wrap_uint8), want)


@pytest.mark.parametrize("fn", ["hist_planes_cols", "hist_planes_cols_sorted"])
def test_raster_non_cuda_device_raises(fn):
    col = torch.zeros(2, 5, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        getattr(vh, fn)(col, col, 4, 4, raster=True)


_SHAPES = {"cls_256": (30_000, 256, 256), "dsec_440x640": (180_000, 440, 640),
           "voxel6_1536x256": (30_000, 1536, 256)}


def _bands(plan, H):
    """(first row, rows) of every band of one sample, as the kernel numbers
    them (csrc/voxelize_hist.cuh hist_band_kernel): the last one cut at H."""
    return [(r0, min(plan.rows, H - r0)) for r0 in range(0, H, plan.rows)]


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("shape", sorted(_SHAPES))
@pytest.mark.parametrize("B", [1, 8, 16, 64])
def test_plan_covers_every_row_once_in_one_wave(B, shape, skip, sms):
    """Every row of a sample lies in exactly one block's band; a block stays
    within 232,448 bytes; the grid holds at most one block an SM (one wave)
    and its blocks cover every item in ``rounds``: on the H100 SXM's 132 SMs
    and on cards with fewer."""
    N, H, W = _SHAPES[shape]
    p = vh.hist_plan(B, N, H, W, sms, skip)
    rows = [r for r0, n in _bands(p, H) for r in range(r0, r0 + n)]
    assert rows == list(range(H))
    assert p.smem == vh.HEADER_BYTES + p.rows * 2 * W * p.counter_bytes <= vh.SMEM_LIMIT
    assert 1 <= p.blocks <= sms and p.waves == 1
    assert p.items == B * len(_bands(p, H))
    assert p.blocks * p.rounds >= p.items > p.blocks * (p.rounds - 1)
    assert p.counter_bytes == (2 if N <= vh.NARROW_MAX_N else 4)


def test_plan_at_the_dsec_shape():
    """K4's presorted plan at (8, 180,000, 440x640): 28 rows a block, 128
    blocks on 132 SMs, one band each; 32-bit counters (N >= 65,536)."""
    p = vh.hist_plan(8, 180_000, 440, 640, 132, skip=True)
    assert (p.rows, p.blocks, p.rounds, p.waves, p.counter_bytes) == (28, 128, 1, 1, 4)


@pytest.mark.parametrize("B,rows,blocks", [(8, 16, 128), (64, 128, 128)])
def test_plan_at_the_cls_shapes(B, rows, blocks):
    """K1's plan on the 256x256 canvas at N = 30,000: 16-bit counters, about
    one block an SM."""
    p = vh.hist_plan(B, 30_000, 256, 256, 132)
    assert (p.rows, p.blocks, p.rounds, p.counter_bytes) == (rows, blocks, 1, 2)


@pytest.mark.parametrize("N,want", [(0, 2), (65_535, 2), (65_536, 4), (180_000, 4)])
def test_plan_counter_width(N, want):
    """16-bit counters only where N proves no cell reaches 65,536."""
    assert vh.hist_plan(8, N, 256, 256).counter_bytes == want


def test_plan_limits():
    """A row wider than a block's shared memory, and an empty batch or
    canvas, are refused; a canvas taller than the card's bands takes rounds."""
    p = vh.hist_plan(64, 30_000, 1536, 256, 132)
    assert p.rows * 2 * 256 * 2 <= vh.SMEM_LIMIT and p.rounds > 1 and p.blocks == 132
    with pytest.raises(ValueError):
        vh.hist_plan(1, 100_000, 4, 30_000)
    with pytest.raises(ValueError):
        vh.hist_plan(0, 30_000, 256, 256)
