"""The port's training augmentations held against the JAX package at fixed
draws: each RandAugment op (ops/rand_augment.py vs rand_augment._apply_op
and _geometric_round), the magnitude table, ColorJitter at fixed factors
and order, and the random crop at fixed offsets; plus the host draws of
data/device_pipeline.draw_train_aug (the port's stand-in for the
reference's jax.random draws)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mem_tpu.ops import image_ops as jax_image_ops
from mem_tpu.ops import rand_augment as jax_ra
from mem_tpu_torch.data.device_pipeline import PreprocConfig, draw_train_aug
from mem_tpu_torch.ops import image_ops
from mem_tpu_torch.ops import rand_augment as ra

H, W = 24, 20
# f32 pixel values before truncation: the lerps and blends are the same f32
# ops; XLA may contract a multiply-add that torch rounds twice -> 1e-3 on
# values up to 255. After the uint8 truncation such an ulp can flip one
# level. Equalize, Posterize and Solarize are integer / select ops: exact.
F32_TOL = 1e-3
_EXACT = {"Equalize", "Posterize", "Solarize"}


def _image(rng):
    img = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    img[:5, :4] = 0                      # a flat corner (AutoContrast / Equalize edges)
    img[-3:, -6:] = 200
    return img


def _u8(x):
    return np.clip(x, 0, 255).astype(np.uint8).astype(np.int32)


def _cases():
    table = np.asarray(jax_ra._magnitude_table(H, W))
    for op, name in enumerate(ra.OP_NAMES):
        for b in (7, 20):
            for sign in (1.0, -1.0):
                yield pytest.param(op, float(sign * table[op, b]), id=f"{name}-bin{b}-{sign:+.0f}")


@pytest.mark.parametrize("op,mag", list(_cases()))
def test_op_matches_jax(rng, op, mag):
    img = _image(rng)
    x_j = jnp.asarray(img, jnp.float32)
    x_t = torch.from_numpy(img).float()[None]
    m_t = torch.tensor([mag], dtype=torch.float32)
    want = np.asarray(jax_ra._apply_op(x_j, op, jnp.float32(mag)))
    got = ra.apply_op(x_t, op, m_t)[0].numpy()
    geo_want = np.asarray(jax_ra._geometric_round(x_j, jnp.int32(op), jnp.float32(mag), H, W))
    geo_got = ra.geometric_round(x_t, torch.tensor([op]), m_t)[0].numpy()
    if ra.OP_NAMES[op] in _EXACT:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    assert np.abs(_u8(got) - _u8(want)).max() <= 1
    np.testing.assert_allclose(geo_got, geo_want, rtol=0, atol=F32_TOL)


def test_magnitude_table_matches_jax():
    want = np.asarray(jax_ra._magnitude_table(224, 224))
    got = ra.magnitude_table(224, 224).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_photometric_select_is_the_per_sample_switch(rng):
    imgs = np.stack([_image(rng) for _ in range(4)]).astype(np.float32)
    ops = np.array([7, 0, 13, 10])
    mags = np.array([0.3, 0.0, 0.0, 4.0], np.float32)
    got = ra.photometric_select(torch.from_numpy(imgs), torch.from_numpy(ops),
                                torch.from_numpy(mags)).numpy()
    for b in range(4):
        want = np.asarray(jax_ra._apply_op(jnp.asarray(imgs[b]), int(ops[b]),
                                           jnp.float32(mags[b])))
        np.testing.assert_allclose(got[b], want, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("batch_ops", [False, True])
def test_draws_ranges_and_batch_op_sharing(batch_ops):
    cfg = PreprocConfig(input_h=224, input_w=224, color_jitter=0.4,
                        rand_aug_batch_ops=batch_ops)
    seeds = np.arange(500, dtype=np.uint32) * 7919
    d = draw_train_aug(seeds, cfg, 256, 342)
    assert d["crop_tl"].shape == (500, 2)
    assert d["crop_tl"][:, 0].min() == 0 and d["crop_tl"][:, 0].max() <= 32
    assert d["crop_tl"][:, 1].max() <= 118 and d["crop_tl"][:, 1].max() > 100
    for k, hi in (("ra_ops", 13), ("ra_bins", 20), ("ra_signs", 1)):
        assert d[k].shape == (500, 2) and d[k].min() >= 0 and d[k].max() <= hi, k
        if not (batch_ops and k == "ra_ops"):
            assert d[k].min() == 0 and d[k].max() == hi, k
    for k in ("cj_brightness", "cj_saturation"):
        assert 0.6 <= d[k].min() and d[k].max() < 1.4 and d[k].std() > 0.1, k
    assert 0.4 < d["cj_order"].mean() < 0.6
    if batch_ops:
        assert d["ra_batch_ops"].shape == (2,)
        assert (d["ra_ops"] == d["ra_batch_ops"][None, :]).all()
    else:
        assert "ra_batch_ops" not in d and len(np.unique(d["ra_ops"][:, 0])) == 14
    again = draw_train_aug(seeds, cfg, 256, 342)
    for k in d:
        np.testing.assert_array_equal(again[k], d[k])


@pytest.mark.parametrize("brightness_first", [True, False])
def test_color_jitter_matches_jax(rng, brightness_first):
    img = rng.random((2, 12, 10, 3)).astype(np.float32)
    bf, sf = np.float32([0.7, 1.3]), np.float32([1.25, 0.8])

    def jax_one(x, b, s):
        if brightness_first:
            return jax_image_ops._adjust_saturation(jax_image_ops._adjust_brightness(x, b), s)
        return jax_image_ops._adjust_brightness(jax_image_ops._adjust_saturation(x, s), b)

    want = np.stack([np.asarray(jax_one(jnp.asarray(img[i]), bf[i], sf[i])) for i in range(2)])
    got = image_ops.color_jitter_batch(torch.from_numpy(img), torch.from_numpy(bf),
                                       torch.from_numpy(sf),
                                       torch.tensor([brightness_first] * 2)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_random_crop_matches_jax(rng):
    img = rng.random((3, 20, 24, 3)).astype(np.float32)
    tops, lefts = np.array([0, 4, 9]), np.array([7, 0, 30])   # 30: clamped into the image
    want = np.asarray(jax_image_ops.random_crop_batch(jnp.asarray(img), jnp.asarray(tops),
                                                      jnp.asarray(lefts), 11, 13))
    got = image_ops.random_crop_batch(torch.from_numpy(img), torch.from_numpy(tops),
                                      torch.from_numpy(lefts), 11, 13).numpy()
    np.testing.assert_array_equal(got, want)
