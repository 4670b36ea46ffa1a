"""The IMNET path's device augmentations held against the JAX package at the
reference's own draws: the JAX package draws RandAugment's op, level, sign
and apply gate and the erasing boxes from jax.random keys on the device; the
tests replay those key splits with jax.random (rand_augment.py:354-382,
413-431; image_ops.py:294-331) and feed the values to the port, so both see
the same draws. Also: the port's host draws (timm levels, gates, boxes, the
event path's draws unchanged), random_resized_crop, preprocess_image_cls and
parse_rand_aa."""
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mem_tpu.cli.common import parse_rand_aa as jax_parse_rand_aa
from mem_tpu.data.device_pipeline import preprocess_image_cls as jax_preprocess_image_cls
from mem_tpu.ops import image_ops as jax_image_ops
from mem_tpu.ops import rand_augment as jax_ra
from mem_tpu_torch.cli.common import parse_rand_aa
from mem_tpu_torch.data import device_pipeline as dp
from mem_tpu_torch.data import seg_pipeline as sp
from mem_tpu_torch.ops import image_ops
from mem_tpu_torch.ops import rand_augment as ra

B, H, W = 8, 24, 20
F32_TOL = 1e-3        # tests/test_torch_augment.py: f32 values before the uint8 truncation


def _keys(seeds):
    return jax.vmap(jax.random.key)(jnp.asarray(seeds, jnp.uint32))


def _images(rng, n=B, h=H, w=W):
    imgs = rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)
    imgs[:, :4, :5] = 30           # flat corners: AutoContrast / Equalize edges
    return imgs


def replay_rand_augment(keys, num_ops, magnitude, mstd, prob, batch_ops):
    """The reference's per-sample (or batch_ops) draws from its keys:
    (ops, bins, signs, gate) (B, num_ops) and the batch ops or None."""
    n = keys.shape[0]
    ops = np.zeros((n, num_ops), np.int32)
    bins, signs = np.zeros_like(ops), np.zeros_like(ops)
    gate = np.zeros((n, num_ops), bool)
    b_ops = None
    if batch_ops:
        bk = jax.random.fold_in(keys[0], 0x5EED)
        b_ops = np.zeros(num_ops, np.int32)
        for r in range(num_ops):
            bk, k_op = jax.random.split(bk)
            b_ops[r] = int(jax.random.randint(k_op, (), 0, ra.NUM_OPS))
    for b in range(n):
        key = keys[b]
        for r in range(num_ops):
            if batch_ops:
                k_mag, k_sign, k_ap = jax.random.split(jax.random.fold_in(keys[b], r), 3)
                ops[b, r] = b_ops[r]
            else:
                key, k_op, k_mag, k_sign, k_ap = jax.random.split(key, 5)
                ops[b, r] = int(jax.random.randint(k_op, (), 0, ra.NUM_OPS))
            bins[b, r] = int(jax_ra._draw_bin(k_mag, magnitude, True, mstd))
            signs[b, r] = int(jax.random.randint(k_sign, (), 0, 2))
            gate[b, r] = bool(jax.random.uniform(k_ap) < prob)
    return ops, bins, signs, gate, b_ops


def replay_erasing(keys, H, W, prob, count):
    """The reference's erasing draws (image_ops.py:303-313) as the port's
    {"er_use", "er_box"}."""
    n = keys.shape[0]
    use = np.zeros(n, bool)
    u = np.zeros((n, count, 4), np.float32)
    for b in range(n):
        k_use, key = jax.random.split(keys[b])
        use[b] = bool(jax.random.uniform(k_use) < prob)
        for c in range(count):
            k_area, k_ratio, k_top, k_left, _, key = jax.random.split(key, 6)
            u[b, c] = (float(jax.random.uniform(k_area, (), minval=0.02, maxval=1.0 / 3)),
                       float(jax.random.uniform(k_ratio, (), minval=jnp.log(0.3),
                                                maxval=jnp.log(3.3))),
                       float(jax.random.uniform(k_top)), float(jax.random.uniform(k_left)))
    boxes = image_ops.erasing_boxes(H, W, u[..., 0], u[..., 1], u[..., 2], u[..., 3], count)
    return {"er_use": use, "er_box": boxes}


def _t(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


@pytest.mark.parametrize("batch_ops", [False, True], ids=["per_sample", "batch_ops"])
def test_timm_rand_augment_matches_jax_at_replayed_draws(rng, batch_ops):
    """rand_augment_batch(timm_levels=True, prob=0.5) at m9 / mstd 0.5, 2
    rounds: every sample within 1 LSB of the reference (the rounds' f32
    sums may differ by F32_TOL before the truncation) at a few pixels, and a
    sample whose gates are both off exactly as it came in."""
    imgs = _images(rng)
    keys = _keys(np.arange(B) * 977 + 5)
    want = np.asarray(jax.jit(functools.partial(
        jax_ra.rand_augment_batch, num_ops=2, magnitude=9, batch_ops=batch_ops,
        timm_levels=True, mstd=0.5, prob=0.5))(jnp.asarray(imgs), keys)).astype(np.int32)
    ops, bins, signs, gate, b_ops = replay_rand_augment(keys, 2, 9, 0.5, 0.5, batch_ops)
    assert gate.any() and not gate.all()
    got = ra.rand_augment_batch(torch.from_numpy(imgs), torch.from_numpy(ops),
                                torch.from_numpy(bins), torch.from_numpy(signs), b_ops,
                                gate=torch.from_numpy(gate)).numpy().astype(np.int32)
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.02, (diff.max(), (diff > 0).mean())
    for b in np.flatnonzero(~gate.any(axis=1)):
        np.testing.assert_array_equal(got[b], imgs[b])


def test_timm_bin_is_the_reference_s_draw_bin():
    """The level -> bin map on the reference's own normals, f32 and half to
    even, including the clips at 0 and 10."""
    class Fixed:
        def __init__(self, z):
            self.z = z

        def standard_normal(self):
            return self.z

    for i in range(300):
        k = jax.random.key(i)
        z = float(jax.random.normal(k))
        for m, mstd in ((9, 0.5), (5, 3.0), (0, 1.0), (10, 2.0), (9, 0.0)):
            assert ra.timm_bin(m, mstd, Fixed(z)) == int(jax_ra._draw_bin(k, m, True, mstd)), \
                (i, m, mstd)


def test_timm_draws_ranges():
    rngs = [np.random.default_rng(s) for s in range(400)]
    ops, bins, signs, gate, b_ops = ra.draw_rand_augment(rngs, 2, 9, timm_levels=True,
                                                         mstd=0.0, prob=0.5)
    assert (bins == 27).all() and b_ops is None          # round(9 / 10 * 30)
    assert 0.4 < gate.mean() < 0.6 and set(np.unique(signs)) == {0, 1}
    assert len(np.unique(ops)) == 14
    rngs = [np.random.default_rng(s) for s in range(400)]
    _, bins, _, _, _ = ra.draw_rand_augment(rngs, 2, 9, timm_levels=True, mstd=0.5, prob=0.5)
    assert bins.min() < 27 < bins.max() <= 30 and abs(np.median(bins) - 27) <= 1


def _old_event_draws(aug_seed, cfg, H, W):
    """draw_train_aug as it was before the timm level mode: crop, then per
    sample and round op / bin / sign, then ColorJitter."""
    seeds = [int(s) for s in np.asarray(aug_seed).reshape(-1)]
    rngs = [np.random.default_rng(s) for s in seeds]
    crop = np.array([(r.integers(0, max(H - cfg.input_h, 0) + 1),
                      r.integers(0, max(W - cfg.input_w, 0) + 1)) for r in rngs], np.int32)
    ops, bins, signs = (np.zeros((len(rngs), 2), np.int32) for _ in range(3))
    for b, r in enumerate(rngs):
        for k in range(2):
            ops[b, k] = r.integers(0, 14)
            bins[b, k] = r.integers(0, cfg.rand_aug_magnitude + 1)
            signs[b, k] = r.integers(0, 2)
    out = {"crop_tl": crop, "ra_ops": ops, "ra_bins": bins, "ra_signs": signs}
    s, lo = float(cfg.color_jitter), max(0.0, 1.0 - float(cfg.color_jitter))
    cj = np.array([[r.uniform(lo, 1 + s), r.uniform(lo, 1 + s)] for r in rngs], np.float32)
    out.update(cj_brightness=cj[:, 0], cj_saturation=cj[:, 1],
               cj_order=np.array([r.random() < 0.5 for r in rngs]))
    if cfg.rand_aug_batch_ops:
        b_ops = np.random.default_rng((seeds[0], 0x5EED)).integers(0, 14, size=2)
        out["ra_batch_ops"] = b_ops.astype(np.int32)
        out["ra_ops"][:] = b_ops[None]
    return out


@pytest.mark.parametrize("batch_ops", [False, True])
def test_event_path_draws_unchanged(batch_ops):
    cfg = dp.PreprocConfig(color_jitter=0.4, rand_aug_batch_ops=batch_ops)
    seeds = np.arange(64, dtype=np.uint32) * 7919 + 1
    got = dp.draw_train_aug(seeds, cfg, 256, 342)
    want = _old_event_draws(seeds, cfg, 256, 342)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    seg = sp.draw_seg_train_aug(seeds, batch_ops)
    rngs = [np.random.default_rng(int(s)) for s in seeds]
    for b, r in enumerate(rngs):
        for k in range(2):
            op = ra.PHOTOMETRIC_IDS[r.integers(0, 9)]
            bn, sg = r.integers(0, 11), r.integers(0, 2)
            assert seg["ra_bins"][b, k] == bn and seg["ra_signs"][b, k] == sg
            if not batch_ops:
                assert seg["ra_ops"][b, k] == op


def test_event_rand_augment_without_gate_unchanged(rng):
    """gate=None is the event path's call: the same result as an all-on gate."""
    imgs = torch.from_numpy(_images(rng))
    ops = torch.from_numpy(rng.integers(0, 14, (B, 2)).astype(np.int32))
    bins = torch.from_numpy(rng.integers(0, 21, (B, 2)).astype(np.int32))
    signs = torch.from_numpy(rng.integers(0, 2, (B, 2)).astype(np.int32))
    a = ra.rand_augment_batch(imgs, ops, bins, signs)
    b = ra.rand_augment_batch(imgs, ops, bins, signs, gate=torch.ones(B, 2, dtype=torch.bool))
    assert torch.equal(a, b) and not torch.equal(a, imgs)


# -- RandomErasing -------------------------------------------------------------

@pytest.mark.parametrize("count,h,w", [(1, 24, 20), (2, 17, 33)])
def test_random_erasing_const_exact_at_replayed_draws(rng, count, h, w):
    x = rng.random((B, h, w, 3)).astype(np.float32)
    keys = _keys(np.arange(B) + 100)
    want = np.asarray(jax_image_ops.random_erasing_batch(jnp.asarray(x), keys, 0.5, "const",
                                                         count))
    draws = replay_erasing(keys, h, w, 0.5, count)
    assert draws["er_use"].any() and not draws["er_use"].all()
    got = image_ops.random_erasing_batch(torch.from_numpy(x), _t(draws), "const").numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["pixel", "rand"])
def test_random_erasing_noise_box_exact_and_normal(rng, mode):
    """The fill's bits differ between the two sides: the erased pixels are
    the same set, and the fill is N(0, 1) (per pixel, or per channel)."""
    n, h, w = 32, 40, 36
    x = (0.25 + 0.5 * rng.random((n, h, w, 3))).astype(np.float32)
    keys = _keys(np.arange(n) + 7)
    want = np.asarray(jax_image_ops.random_erasing_batch(jnp.asarray(x), keys, 1.0, mode, 1))
    g = torch.Generator().manual_seed(3)
    got = image_ops.random_erasing_batch(torch.from_numpy(x), _t(replay_erasing(keys, h, w,
                                                                                1.0, 1)),
                                         mode, g).numpy()
    erased = got != x
    np.testing.assert_array_equal(erased, want != x)
    fill = got[erased]
    assert fill.size > 2000
    if mode == "pixel":
        assert abs(fill.mean()) < 0.05 and abs(fill.std() - 1) < 0.05
    else:
        for b in range(n):     # one value per channel inside the box
            vals = got[b][erased[b].any(-1)]
            assert (vals == vals[0]).all()


def test_erasing_draws_and_arguments():
    rngs = [np.random.default_rng(s) for s in range(500)]
    d = image_ops.draw_random_erasing(rngs, 224, 224, 0.25, count=2)
    assert d["er_box"].shape == (500, 2, 4) and 0.2 < d["er_use"].mean() < 0.3
    top, left, h, w = np.moveaxis(d["er_box"], -1, 0)
    assert h.min() >= 1 and w.min() >= 1 and (top + h).max() <= 224 and (left + w).max() <= 224
    area = (h * w) / (224 * 224 / 2)
    assert 0.015 < area.min() and area.max() < 0.36
    with pytest.raises(ValueError, match="remode"):
        image_ops.random_erasing_batch(torch.zeros(1, 4, 4, 3), _t(d), "weird")


# -- random resized crop -------------------------------------------------------

@pytest.mark.parametrize("shape,scale", [((30, 26, 3), (0.08, 1.0)), ((12, 60, 3), (0.5, 1.0)),
                                         ((60, 12, 3), (0.5, 1.0))],
                         ids=["draws", "wide_fallback", "tall_fallback"])
def test_random_resized_crop_matches_jax(rng, shape, scale):
    img = rng.random(shape).astype(np.float32)
    ratio = (3.0 / 4.0, 4.0 / 3.0)
    for seed in range(4):
        key = jax.random.key(seed)
        want = np.asarray(jax_image_ops.random_resized_crop(jnp.asarray(img), key, 16, 18,
                                                            scale, ratio))
        k_area, k_ar, k_pos = jax.random.split(key, 3)
        area = np.asarray(jax.random.uniform(k_area, (10,), minval=scale[0], maxval=scale[1]))
        log_r = np.asarray(jax.random.uniform(k_ar, (10,), minval=jnp.log(ratio[0]),
                                              maxval=jnp.log(ratio[1])))
        u, v = np.asarray(jax.random.uniform(k_pos, (2,)))
        window = image_ops.rrc_window(shape[0], shape[1], area, log_r, u, v, ratio)
        got = image_ops.random_resized_crop(torch.from_numpy(img), window, 16, 18).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    win = image_ops.draw_rrc_window(np.random.default_rng(0), 30, 26)
    assert 0 <= win[0] and win[0] + win[2] <= 30 + 1e-4 and win[1] + win[3] <= 26 + 1e-4


# -- preprocess_image_cls --------------------------------------------------------

def _image_batch(rng, n=B, h=H, w=W):
    return {"image": rng.random((n, h, w, 3)).astype(np.float32),
            "aug_seed": (np.arange(n) * 31 + 9).astype(np.uint32),
            "label": np.zeros(n, np.int64)}


def test_preprocess_image_cls_eval_untouched_and_missing_draws_raise(rng):
    batch = _image_batch(rng)
    out = dp.preprocess_image_cls(_t(batch), is_train=False)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), batch["image"])
    with pytest.raises(ValueError, match="draw_image_aug"):
        dp.preprocess_image_cls(_t(batch), is_train=True)
    same = dp.preprocess_image_cls(_t(batch), is_train=True, rand_aug=False, reprob=0.0)
    np.testing.assert_array_equal(same.numpy(), batch["image"])


@pytest.mark.parametrize("batch_ops", [False, True], ids=["per_sample", "batch_ops"])
def test_preprocess_image_cls_train_matches_jax_at_replayed_draws(rng, batch_ops):
    """The whole train stack (ToUint8, timm RandAugment m9 / mstd 0.5 /
    prob 0.5, ToFloat32, const erasing at 0.5) on the reference's draws from
    aug_seed folded with 1 and 2: within 1 LSB / 255 at a few pixels."""
    batch = _image_batch(rng)
    keys = _keys(batch["aug_seed"])
    aug = dict(rand_aug=True, magnitude=9, num_ops=2, mstd=0.5, reprob=0.5, remode="const",
               recount=1, batch_ops=batch_ops)
    want = np.asarray(jax.jit(functools.partial(jax_preprocess_image_cls, is_train=True, **aug))(
        {k: jnp.asarray(v) for k, v in batch.items()}))
    ra_keys = jax.vmap(lambda k: jax.random.fold_in(k, 1))(keys)
    er_keys = jax.vmap(lambda k: jax.random.fold_in(k, 2))(keys)
    ops, bins, signs, gate, b_ops = replay_rand_augment(ra_keys, 2, 9, 0.5, 0.5, batch_ops)
    draws = {"ra_ops": ops, "ra_bins": bins, "ra_signs": signs, "ra_gate": gate,
             **replay_erasing(er_keys, H, W, 0.5, 1)}
    tb = _t({**batch, **draws})
    if batch_ops:
        tb["ra_batch_ops"] = b_ops
    got = dp.preprocess_image_cls(tb, is_train=True, rand_aug=True, reprob=0.5,
                                  remode="const").numpy()
    diff = np.abs(got - want) * 255
    assert diff.max() <= 1 + 1e-3 and (diff > 1e-3).mean() <= 0.02


def test_draw_image_aug_shapes_and_streams():
    seeds = np.arange(300, dtype=np.uint32) * 13
    d = dp.draw_image_aug(seeds, (224, 200), magnitude=9, num_ops=3, mstd=0.5, reprob=0.25,
                          recount=2, batch_ops=True)
    assert d["ra_ops"].shape == d["ra_gate"].shape == (300, 3)
    assert (d["ra_ops"] == d["ra_batch_ops"][None]).all()
    assert d["er_box"].shape == (300, 2, 4) and (d["er_box"][..., 2] <= 223).all()
    assert 0.4 < d["ra_gate"].mean() < 0.6 and 0.18 < d["er_use"].mean() < 0.32
    again = dp.draw_image_aug(seeds, (224, 200), magnitude=9, num_ops=3, mstd=0.5, reprob=0.25,
                              recount=2, batch_ops=True)
    for k in d:
        np.testing.assert_array_equal(again[k], d[k])
    per = dp.draw_image_aug(seeds, (224, 200))
    assert "ra_batch_ops" not in per and per["ra_ops"].shape == (300, 2)
    # preprocess_image_cls takes the rounds from the draws' shapes and the
    # batch_ops form from the presence of ra_batch_ops
    img = torch.from_numpy(np.random.default_rng(1).random((8, 32, 24, 3)).astype(np.float32))
    for draws in (dp.draw_image_aug(seeds[:8], (32, 24), num_ops=3, batch_ops=True),
                  dp.draw_image_aug(seeds[:8], (32, 24), num_ops=1)):
        td = _t(draws)
        got = dp.preprocess_image_cls({"image": img, **td}, True, reprob=0.0)
        u8 = ra.rand_augment_batch((255.0 * img).to(torch.uint8), td["ra_ops"], td["ra_bins"],
                                td["ra_signs"], td.get("ra_batch_ops"), gate=td["ra_gate"])
        np.testing.assert_array_equal(got.numpy(), u8.numpy().astype(np.float32) / 255.0)


# -- --aa ----------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["rand-m9-mstd0.5-inc1", "rand-m5", "rand-n3-m7",
                                  "rand-m0-mstd1.0", "rand", "none", "None", "0", "false", "",
                                  None, "rand-mstd0.2-n1-inc0"])
def test_parse_rand_aa_is_the_reference_s(spec):
    assert parse_rand_aa(spec) == jax_parse_rand_aa(spec)


@pytest.mark.parametrize("spec", ["original", "augmix-m5", "v0"])
def test_parse_rand_aa_refuses_other_specs(spec):
    with pytest.raises(SystemExit, match="rand-"):
        parse_rand_aa(spec)
    with pytest.raises(SystemExit):
        jax_parse_rand_aa(spec)


def test_erasing_log_ratio_bounds():
    assert image_ops._LOG_RATIO == (math.log(0.3), math.log(3.3))
