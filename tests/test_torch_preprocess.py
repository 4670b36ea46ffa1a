"""The port's preprocessing (voxelize -> resize -> channel ops, and the
training path's flips and shifts) held against
mem_tpu.data.device_pipeline.preprocess_batch on the same numpy batch, for
each dataset profile build_preproc gives; and the compact int16 wire."""
import argparse
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mem_tpu.ops.voxelize as jax_voxelize
from mem_tpu.cli import common as jax_common
from mem_tpu.data.device_pipeline import events_f32 as jax_events_f32
from mem_tpu.data.device_pipeline import preprocess_batch as jax_preprocess_batch
from mem_tpu_torch.cli import common
from mem_tpu_torch.data.device_pipeline import PreprocConfig, events_f32, preprocess_batch
from mem_tpu_torch.ops import image_ops

# the resize and the hot-pixel statistics sum in another order than XLA's
TOL = 1e-5


def _args(add, dataset, **flags):
    p = argparse.ArgumentParser()
    add(p)
    a = p.parse_args([])
    a.data_path = dataset
    for k, v in flags.items():
        setattr(a, k, v)
    return a


@pytest.mark.parametrize("is_train", [False, True])
@pytest.mark.parametrize("dataset", ["ncaltech101", "ncars", "nimagenet", "dsec"])
def test_build_preproc_matches_jax(dataset, is_train):
    flags = dict(input_H=48, input_W=64, normalize_events=1, voxel=0)
    want = jax_common.build_preproc(
        _args(jax_common.add_preprocessing_args, dataset, **flags), is_train)
    got = common.build_preproc(_args(common.add_preprocessing_args, dataset, **flags),
                               is_train)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


_PROFILES = {
    # dataset, input size, preprocessing flags
    "ncaltech101_hotpix_norm": ("ncaltech101", 32, dict(hotpixfilter=1, normalize_events=1)),
    "ncaltech101_log": ("ncaltech101", 32, dict(hotpixfilter=0, normalize_events=0,
                                                 logtrafo=1)),
    "ncaltech101_timesurface": ("ncaltech101", 48, dict(hotpixfilter=1, normalize_events=1,
                                                         timesurface=1)),
    "ncars_hotpix_gamma_norm": ("ncars", 32, dict(hotpixfilter=1, normalize_events=1,
                                                  gammatrafo=1, gamma=0.7)),
    "nimagenet_log_norm": ("nimagenet", 32, dict(hotpixfilter=0, normalize_events=1,
                                                 logtrafo=1)),
    "nimagenet_hotpix": ("nimagenet", 48, dict(hotpixfilter=1, normalize_events=0,
                                               hotpix_num_stds=2.0)),
}


@pytest.mark.parametrize("profile", sorted(_PROFILES))
def test_preprocess_eval_matches_jax(rng, profile):
    dataset, size, flags = _PROFILES[profile]
    flags = dict(flags, input_H=size, input_W=size)
    cfg_j = jax_common.build_preproc(
        _args(jax_common.add_preprocessing_args, dataset, **flags), False)
    cfg_t = common.build_preproc(_args(common.add_preprocessing_args, dataset, **flags), False)
    B, N = 3, 1500
    H, W = cfg_t.canvas_h, cfg_t.canvas_w
    sh = rng.integers(H // 2, H + 1, B).astype(np.int32)
    sw = rng.integers(W // 2, W + 1, B).astype(np.int32)
    ev = np.zeros((B, N, 4), np.float32)
    ev[..., 0] = rng.integers(0, W, (B, N)) % sw[:, None]
    ev[..., 1] = rng.integers(0, H, (B, N)) % sh[:, None]
    ev[..., 2] = np.sort(rng.integers(0, 10**6, (B, N)), axis=1)
    ev[..., 3] = rng.choice([-1.0, 1.0], (B, N))
    ev[0, :300, :2] = (3, 4)                      # one hot pixel
    nv = np.array([N, 1100, 40], np.int32)
    batch = {"events": ev, "n_valid": nv, "sample_h": sh, "sample_w": sw,
             "aug_seed": np.zeros(B, np.uint32)}

    want = np.asarray(jax_preprocess_batch({k: jnp.asarray(v) for k, v in batch.items()},
                                           cfg_j, is_train=False))
    got = preprocess_batch({k: torch.from_numpy(v) for k, v in batch.items()}, cfg_t,
                           is_train=False)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_hot_pixels_topk_mode_matches_jax(rng):
    from mem_tpu.ops.image_ops import remove_hot_pixels as jax_remove_hot_pixels

    img = rng.random((2, 12, 10, 3)).astype(np.float32)
    want = np.asarray(jax_remove_hot_pixels(jnp.asarray(img), num_hot_pixels=7))
    got = image_ops.remove_hot_pixels(torch.from_numpy(img), num_hot_pixels=7)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0)


def test_train_mode_raises():
    """Training preprocessing needs the host augmentation draws: without
    them it raises rather than skip the augmentations."""
    batch = {"events": torch.zeros(1, 4, 4), "n_valid": torch.ones(1, dtype=torch.int32)}
    with pytest.raises(ValueError, match="draw_train_aug"):
        preprocess_batch(batch, PreprocConfig(input_h=32, input_w=32), is_train=True)


@pytest.mark.parametrize("dataset", ["ncaltech101", "ncars"])
def test_preprocess_train_matches_jax(rng, monkeypatch, dataset):
    """is_train=True with RandAugment and ColorJitter off: host-given time
    and x flips and shifts through voxelize (K1 in interpret mode on the JAX
    side), the resize and the channel ops. 1e-5, as the eval path."""
    flags = dict(input_H=32, input_W=32, hotpixfilter=1, normalize_events=1, rand_aug=0,
                 max_random_shift_evs=3)
    cfg_j = jax_common.build_preproc(
        _args(jax_common.add_preprocessing_args, dataset, **flags), True)
    cfg_t = common.build_preproc(_args(common.add_preprocessing_args, dataset, **flags), True)
    assert not cfg_t.rand_aug and cfg_t.color_jitter == 0
    B, N = 4, 1500
    H, W = cfg_t.canvas_h, cfg_t.canvas_w
    sh = rng.integers(H // 2, H + 1, B).astype(np.int32)
    sw = rng.integers(W // 2, W + 1, B).astype(np.int32)
    ev = np.zeros((B, N, 4), np.float32)
    ev[..., 0] = rng.integers(0, W, (B, N)) % sw[:, None]
    ev[..., 1] = rng.integers(0, H, (B, N)) % sh[:, None]
    ev[..., 2] = np.sort(rng.integers(0, 10**6, (B, N)), axis=1)
    ev[..., 3] = rng.choice([-1.0, 1.0], (B, N))
    batch = {"events": ev, "n_valid": np.array([N, 1100, 40, N], np.int32),
             "sample_h": sh, "sample_w": sw,
             "time_flip": np.array([True, False, True, False]),
             "x_flip": np.array([True, True, False, False]),
             "shift_xy": rng.integers(-3, 4, (B, 2)).astype(np.int32),
             "aug_seed": np.arange(B, dtype=np.uint32)}
    monkeypatch.setattr(jax_voxelize, "PALLAS_HIST", True)
    want = np.asarray(jax_preprocess_batch({k: jnp.asarray(v) for k, v in batch.items()},
                                           cfg_j, is_train=True))
    got = preprocess_batch({k: torch.from_numpy(v) for k, v in batch.items()
                            if k != "aug_seed"}, cfg_t, is_train=True)
    assert got.shape == want.shape == (B, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("scaled", [False, True])
def test_compact_wire_matches_jax_exactly(scaled):
    """events_f32 on the int16 [x, y, p] wire, for every raw coordinate of
    the 640 x 480 N-ImageNet extents: with the on-device rescale (one f64
    multiply, one f32 round) it equals the JAX table lookup bit for bit."""
    x = np.arange(640)
    xyp = np.stack([x, x % 480, np.where(x % 3, 1, -1)], axis=-1).astype(np.int16)[None]
    plan = ((256, 480, 640), (256, 480, 480)) if scaled else None
    want = np.asarray(jax_events_f32({"events_xyp": jnp.asarray(xyp)}, plan))
    got = events_f32({"events_xyp": torch.from_numpy(xyp)}, plan).numpy()
    assert got.dtype == np.float32 and got.shape == (1, 640, 4)
    np.testing.assert_array_equal(got, want)
    if scaled:
        np.testing.assert_array_equal(got[0, :, 0], (x * (256 / 480)).astype(np.float32))
