"""The port's sorted histogram (K4's plain version), the K1-vs-K4 routing and
the ``y_sorted`` argument of voxelize_fused held against the JAX package on
the same numpy inputs. Counts are integers: every comparison here is exact."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mem_tpu.ops.voxelize as vx
from mem_tpu.ops.voxelize_pallas import WIDE_CANVAS_CELLS as JAX_WIDE_CANVAS_CELLS
from mem_tpu.ops.voxelize_pallas import hist_planes_cols_sorted as jax_hist_sorted
from mem_tpu_torch.ops import voxelize as tvx
from mem_tpu_torch.ops import voxelize_hist as vh


def _events(rng, B, N, H, W, tail=100):
    """Packed (col, ys) with an invalid tail (the zero-pad rewritten to the
    sentinels 2W / H), as pack_cols leaves them."""
    col = rng.integers(0, 2 * W, (B, N)).astype(np.int32)
    ys = rng.integers(0, H, (B, N)).astype(np.int32)
    col[:, N - tail:] = 2 * W
    ys[:, N - tail:] = H
    return col, ys


def _presort(col, ys):
    order = np.argsort(ys, axis=1, kind="stable")
    return np.take_along_axis(col, order, axis=1), np.take_along_axis(ys, order, axis=1)


@pytest.mark.parametrize("presorted", [False, True])
def test_sorted_reference_matches_pallas_interpret(rng, presorted):
    """Plain K4 == the Pallas row-tiled kernel (interpret mode, as
    tests/test_voxelize_pallas.py runs it), unsorted and host-presorted."""
    B, N, H, W = 2, 4000, 220, 320
    col, ys = _events(rng, B, N, H, W)
    if presorted:
        col, ys = _presort(col, ys)
    want = np.asarray(jax_hist_sorted(jnp.asarray(col), jnp.asarray(ys), H, W, chunk=512,
                                      presorted=presorted, interpret=True))
    got = vh.hist_planes_cols_sorted_reference(torch.from_numpy(col), torch.from_numpy(ys),
                                               H, W, presorted=presorted)
    assert got.dtype == torch.int32 and got.shape == (B, H, 2 * W)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    # the CPU wrapper takes the plain version
    np.testing.assert_array_equal(
        vh.hist_planes_cols_sorted(torch.from_numpy(col), torch.from_numpy(ys), H, W,
                                   presorted=presorted).numpy(), got.numpy())


def test_sorted_equals_dense_with_stray_values(rng):
    """K4's plain version == K1's on negatives, sentinels and values past
    them, in any order; a broken ``presorted`` promise changes nothing."""
    B, N, H, W = 3, 3000, 50, 37
    col = rng.integers(-2, 2 * W + 3, (B, N)).astype(np.int32)
    ys = rng.integers(-2, H + 3, (B, N)).astype(np.int32)
    c, y = torch.from_numpy(col), torch.from_numpy(ys)
    want = vh.hist_planes_cols_reference(c, y, H, W)
    assert torch.equal(vh.hist_planes_cols_sorted_reference(c, y, H, W), want)
    assert torch.equal(vh.hist_planes_cols_sorted_reference(c, y, H, W, presorted=True), want)


def test_sort_events_by_row_is_the_packed_key_sort(rng):
    """Rows ascending, invalid events last at the sentinel H, the multiset
    of valid (row, col) pairs unchanged."""
    B, N, H, W = 2, 500, 30, 20
    col, ys = _events(rng, B, N, H, W, tail=40)
    ys[:, N - 40:N - 20] = H + 7          # any ys >= H folds onto H
    c, y = vh.sort_events_by_row(torch.from_numpy(col), torch.from_numpy(ys), H)
    assert bool((y[:, 1:] >= y[:, :-1]).all())
    assert bool((y[:, N - 40:] == H).all()) and bool((y[:, :N - 40] < H).all())
    for b in range(B):
        want = sorted(zip(ys[b, :N - 40].tolist(), col[b, :N - 40].tolist()))
        assert list(zip(y[b, :N - 40].tolist(), c[b, :N - 40].tolist())) == want


def test_empty_samples(rng):
    """A sample with no valid event gives an all-zero plane; others are
    untouched by it."""
    B, N, H, W = 3, 800, 40, 24
    col, ys = _events(rng, B, N, H, W)
    col[1], ys[1] = 2 * W, H
    got = vh.hist_planes_cols_sorted(torch.from_numpy(col), torch.from_numpy(ys), H, W)
    assert int(got[1].abs().sum()) == 0
    assert int(got[0].sum()) == N - 100 and int(got[2].sum()) == N - 100
    none = vh.hist_planes_cols_sorted(torch.zeros(2, 0, dtype=torch.int32),
                                      torch.zeros(2, 0, dtype=torch.int32), H, W)
    assert none.shape == (2, H, 2 * W) and int(none.abs().sum()) == 0


@pytest.mark.parametrize("H,W,want", [
    (440, 640, "sorted"),      # DSEC: 563,200 cells
    (256, 256, "dense"),       # N-Caltech101: 131,072 cells
    (1536, 256, "sorted"),     # --voxel 6 at 256^2: bin-folded rows
    (100, 1500, "sorted"),     # exactly at the threshold: 300,000 cells
    (100, 1499, "dense"),      # just under it
    (80, 2048, "dense"),       # wide enough, but 2W = 4096 overflows the key's 12 bits
])
def test_routing_threshold(monkeypatch, H, W, want):
    """voxelize_planes sends H * 2W >= 300,000 cells with 2W < 4096 to K4,
    everything else to K1 (voxelize_pallas.py:204-210)."""
    assert vh.WIDE_CANVAS_CELLS == JAX_WIDE_CANVAS_CELLS == 300_000
    calls = []

    def fake(name):
        def f(col, ys, h, w, **kw):
            calls.append((name, kw))
            return torch.zeros(col.shape[0], h, 2 * w, dtype=torch.int32)
        return f

    monkeypatch.setattr(vh, "hist_planes_cols", fake("dense"))
    monkeypatch.setattr(vh, "hist_planes_cols_sorted", fake("sorted"))
    z = torch.zeros(1, 4, dtype=torch.int32)
    one = torch.ones(1, 4)
    vh.voxelize_planes(z, z, one, 0 * one, H, W, y_sorted=True)
    assert [c[0] for c in calls] == [want]
    if want == "sorted":
        assert calls[0][1] == {"presorted": True}


@pytest.mark.parametrize("y_sorted", [False, True])
def test_voxelize_fused_wide_canvas_matches_jax(rng, monkeypatch, y_sorted):
    """voxelize_fused on the DSEC canvas (the K4 route) == the JAX package's
    on its Pallas route in interpret mode, with the host presort promised
    and not."""
    B, N, H, W = 2, 3000, 440, 640
    ev = np.zeros((B, N, 4), np.float32)
    ev[..., 0] = rng.integers(0, W, (B, N))
    ev[..., 1] = np.sort(rng.integers(0, H, (B, N)), axis=1)
    ev[..., 3] = rng.choice([-1.0, 1.0], (B, N))
    ev[0, :300, :2] = (7, 0)               # > 255 hits on one pixel: the uint8 wrap
    nv = np.array([N, 1234], np.int32)
    monkeypatch.setattr(vx, "PALLAS_HIST", True)
    want = np.asarray(vx.voxelize_fused(jnp.asarray(ev), jnp.asarray(nv), H, W,
                                        y_sorted=y_sorted))
    got = tvx.voxelize_fused(torch.from_numpy(ev), torch.from_numpy(nv), H, W,
                             y_sorted=y_sorted)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[1].sum()) == 1234


def test_voxel_grid_never_promises_sorted(monkeypatch):
    """Bin folding breaks the host presort: the voxel-grid branch routes
    with y_sorted=False whatever the caller said (voxelize.py:338-342)."""
    seen = []
    real = tvx.voxelize_planes

    def spy(*a, **kw):
        seen.append(kw.get("y_sorted"))
        return real(*a, **kw)

    monkeypatch.setattr(tvx, "voxelize_planes", spy)
    ev = torch.zeros(1, 8, 4)
    ev[..., 3] = 1.0
    ev[0, :, 2] = torch.arange(8.0)
    tvx.voxelize_fused(ev, torch.tensor([8]), 16, 16, y_sorted=True, n_bins=3)
    tvx.voxelize_fused(ev, torch.tensor([8]), 16, 16, y_sorted=True)
    assert seen == [False, True]
