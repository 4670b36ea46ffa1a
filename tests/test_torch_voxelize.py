"""The port's event histogram (K1's plain version) and voxelize_fused held
against the JAX package on the same numpy inputs. Rasters are integers:
every comparison here is exact."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mem_tpu.ops.voxelize as vx
from mem_tpu.ops.voxelize import voxelize_numpy
from mem_tpu.ops.voxelize_pallas import hist_planes_cols as jax_hist_planes_cols
from mem_tpu.ops.voxelize_pallas import pack_cols as jax_pack_cols
from mem_tpu_torch.ops import voxelize as tvx
from mem_tpu_torch.ops.voxelize_hist import (hist_planes_cols, hist_planes_cols_reference,
                                             pack_cols, voxelize_planes)


@pytest.mark.parametrize("B,N,H,W", [(3, 1500, 24, 20), (2, 700, 9, 33)])
def test_hist_reference_matches_pallas_interpret(rng, B, N, H, W):
    """Plain K1 == the Pallas dense kernel (interpret mode), exactly, with
    out-of-range and sentinel columns/rows mixed in."""
    col = rng.integers(-2, 2 * W + 3, (B, N)).astype(np.int32)
    ys = rng.integers(-2, H + 3, (B, N)).astype(np.int32)
    col[:, :50] = 2 * W          # pack_cols' invalid sentinels
    ys[:, 50:100] = H
    want = np.asarray(jax_hist_planes_cols(jnp.asarray(col), jnp.asarray(ys), H, W,
                                           chunk=512, interpret=True))
    got = hist_planes_cols_reference(torch.from_numpy(col), torch.from_numpy(ys), H, W)
    assert got.dtype == torch.int32 and got.shape == (B, H, 2 * W)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    # the CPU wrapper takes the plain version
    np.testing.assert_array_equal(
        hist_planes_cols(torch.from_numpy(col), torch.from_numpy(ys), H, W).numpy(),
        got.numpy())


def test_hist_planes_match_voxelize_numpy(rng):
    """pack_cols + plain K1, wrapped mod 256 == the bit-exact numpy
    rasterizer's count channels (uint8 overflow included)."""
    B, N, H, W = 3, 2000, 16, 12
    xs = rng.integers(0, W, (B, N))
    ys = rng.integers(0, H, (B, N))
    ps = rng.choice([-1.0, 1.0], (B, N))
    xs[1, :600] = 3                     # 600+ hits on one pixel: wraps at 256
    ys[1, :600] = 5
    nv = np.array([N, 777, 0])
    idx = np.arange(N)[None]
    ok = idx < nv[:, None]
    wpos = torch.from_numpy((ok & (ps == 1)).astype(np.float32))
    wneg = torch.from_numpy((ok & (ps == -1)).astype(np.float32))
    planes = voxelize_planes(torch.from_numpy(xs), torch.from_numpy(ys), wpos, wneg, H, W)
    planes = torch.remainder(planes, 256).numpy()
    for b in range(B):
        ev = np.stack([xs[b], ys[b], np.zeros(N), ps[b]], -1)[: nv[b]]
        want = voxelize_numpy(ev, H, W)
        np.testing.assert_array_equal(planes[b, :, :W], want[..., 0])
        np.testing.assert_array_equal(planes[b, :, W:], want[..., 2])


def test_pack_cols_matches_jax(rng):
    B, N, H, W = 2, 300, 10, 14
    xs = rng.integers(0, W, (B, N)).astype(np.int32)
    ys = rng.integers(0, H, (B, N)).astype(np.int32)
    pol = rng.integers(0, 3, (B, N))            # 0 = invalid, 1 = pos, 2 = neg
    wpos = (pol == 1).astype(np.float32)
    wneg = (pol == 2).astype(np.float32)
    jc, jy = jax_pack_cols(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(wpos),
                           jnp.asarray(wneg), H, W)
    tc, ty = pack_cols(*(torch.from_numpy(a) for a in (xs, ys, wpos, wneg)), H, W)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


_CASES = {
    "plain": dict(),
    "augmented_time_surface": dict(time_flip=True, x_flip=True, shift=True,
                                   sample_hw=True, time_surface=True),
    "saturate_no_wrap": dict(wrap_uint8=False, sample_hw=True),
    "voxel_grid_2_bins": dict(n_bins=2, x_flip=True, shift=True),
    "slice_window": dict(slice_window=True, time_surface=True),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_voxelize_fused_matches_jax(rng, monkeypatch, case):
    """The port's voxelize_fused == mem_tpu's with the Pallas histogram
    forced (K1 in interpret mode): flips, shifts, per-sample extents, the
    time surface, the clamp mode and the voxel grid. uint8, exact."""
    opts = _CASES[case]
    B, N, H, W = 4, 1200, 40, 32
    ev = np.zeros((B, N, 4), np.float32)
    ev[..., 0] = rng.integers(-3, W + 3, (B, N))     # includes OOB after shift
    ev[..., 1] = rng.integers(-3, H + 3, (B, N))
    ev[..., 2] = np.sort(rng.integers(0, 10**6, (B, N)), axis=1)
    ev[..., 3] = rng.choice([-1.0, 1.0], (B, N))
    ev[0, :400, :2] = (5, 7)                          # > 255 hits on one pixel
    nv = np.array([N, 900, N, 3], np.int32)
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
    if opts.get("slice_window"):
        kw["slice_start"] = rng.integers(0, 200, B).astype(np.int32)
    static = dict(time_surface=opts.get("time_surface", False),
                  wrap_uint8=opts.get("wrap_uint8", True), n_bins=opts.get("n_bins", 0))
    if opts.get("slice_window"):
        static["slice_len"] = 500

    monkeypatch.setattr(vx, "PALLAS_HIST", True)
    want = np.asarray(vx.voxelize_fused(
        jnp.asarray(ev), jnp.asarray(nv), H, W,
        **{k: jnp.asarray(v) for k, v in kw.items()}, **static))
    got = tvx.voxelize_fused(
        torch.from_numpy(ev), torch.from_numpy(nv), H, W,
        **{k: torch.from_numpy(v) for k, v in kw.items()}, **static)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_hist_non_cuda_device_raises():
    col = torch.zeros(2, 5, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        hist_planes_cols(col, col, 4, 4)
