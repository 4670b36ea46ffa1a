"""The port's IMNET host pipeline held against the JAX package: the JPEG
ImageFolder, the two-view pretraining batches and the classification
batches (train and eval, masks, aug_seeds and the wrapped eval padding)
byte for byte against mem_tpu.data.image_pipeline on the same PIL,
``rrc_params`` over 200 (w, h, seed), and the unwired extra transforms
exactly against mem_tpu.data.extra_transforms."""
import os

import numpy as np
import pytest

from mem_tpu.data import extra_transforms as jax_extra
from mem_tpu.data import image_pipeline as jax_ip
from mem_tpu_torch.data import extra_transforms as extra
from mem_tpu_torch.data import image_pipeline as ip


@pytest.fixture(scope="module")
def jpeg_root(tmp_path_factory):
    """Two classes of 32-96 px JPEGs (and one PNG) in train/ and val/."""
    from PIL import Image

    root = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(5)
    for split, n_per in (("train", 7), ("val", 3)):
        for ci, cls in enumerate(["dark", "bright"]):
            d = root / split / cls
            d.mkdir(parents=True)
            base = 50 if ci == 0 else 170
            for i in range(n_per):
                w, h = int(rng.integers(32, 97)), int(rng.integers(32, 97))
                arr = np.clip(base + rng.normal(0, 40, (h, w, 3)), 0, 255).astype(np.uint8)
                ext = "png" if i == 0 and ci == 1 else "jpg"
                Image.fromarray(arr).save(d / f"s{i}.{ext}")
    (root / "train" / "dark" / "notes.txt").write_text("not an image")
    return str(root)


def test_image_folder_matches_jax(jpeg_root):
    for split in ("train", "val"):
        got = ip.ImageFolder(os.path.join(jpeg_root, split))
        want = jax_ip.ImageFolder(os.path.join(jpeg_root, split))
        assert got.samples == want.samples and got.classes == want.classes
        assert got.nb_classes == 2 and len(got) == len(want)
    assert ip.IMG_EXTENSIONS == jax_ip.IMG_EXTENSIONS


def _epochs(mod, root, split, n_epochs, **cfg):
    it = mod.ImageBatchIterator(mod.ImageFolder(os.path.join(root, split)),
                                mod.ImagePipelineConfig(**cfg))
    return it.steps_per_epoch(), [list(it.epoch(e)) for e in range(n_epochs)]


_TWO_VIEW = dict(batch_size=4, input_size=32, second_size=32, window_size=(8, 8),
                 num_mask_patches=16, min_mask_patches_per_block=4, seed=3)
_CLS = dict(batch_size=4, input_size=32, classification=True, masking=None, seed=3)


@pytest.mark.parametrize("split,cfg", [
    ("train", dict(_TWO_VIEW)),
    ("train", dict(_TWO_VIEW, interpolation="random", second_interpolation="bicubic",
                   masking="random")),
    ("val", dict(_TWO_VIEW, is_train=False, shuffle=False, drop_last=False)),
    ("train", dict(_CLS)),
    ("train", dict(_CLS, interpolation="bilinear", color_jitter_cls=0.4,
                   use_color_jitter_cls=True)),
    ("val", dict(_CLS, is_train=False, shuffle=False, drop_last=False)),
    ("val", dict(_CLS, input_size=40, is_train=False, shuffle=False, drop_last=False)),
], ids=["two_view_train", "two_view_random_filter", "two_view_eval", "cls_train_aa",
        "cls_train_color_jitter", "cls_eval", "cls_eval_40"])
def test_batches_equal_the_jax_package_s(jpeg_root, split, cfg):
    """Two epochs of every batch: the same keys, dtypes and bytes."""
    steps, got = _epochs(ip, jpeg_root, split, 2, **cfg)
    want_steps, want = _epochs(jax_ip, jpeg_root, split, 2, **cfg)
    assert steps == want_steps and len(got[0]) == steps > 0
    for e in range(2):
        for g, w in zip(got[e], want[e]):
            assert sorted(g) == sorted(w)
            for k in g:
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    first = got[0][0]
    key = "patches" if "patches" in first else "image"
    if "patches" in first:
        assert first["patches"].shape == (4, 32, 32, 3) and first["vae_view"].shape == (4, 32, 32, 3)
        if cfg.get("masking", "block"):
            assert first["mask"].shape == (4, 64) and first["mask"].dtype == bool
    else:
        s = cfg["input_size"]
        assert first["image"].shape == (4, s, s, 3) and first["aug_seed"].dtype == np.uint32
    if split == "val":
        # 6 val images in batches of 4: the second batch wraps to the first two
        last = got[0][-1]
        np.testing.assert_array_equal(last[key][2:], first[key][:2])
        np.testing.assert_array_equal(last["label"][2:], first["label"][:2])
    else:
        # each epoch has its own shuffle and draws
        assert not np.array_equal(first[key], got[1][0][key])


def test_rrc_params_equal_over_200_draws():
    rng = np.random.default_rng(11)
    fallbacks = 0
    for n in range(200):
        w, h = int(rng.integers(8, 600)), int(rng.integers(8, 600))
        scale = (0.08, 1.0) if n % 4 else (0.9, 1.0)
        ratio = (3.0 / 4.0, 4.0 / 3.0) if n % 5 else (0.2, 0.3)
        got = ip.rrc_params(w, h, np.random.default_rng(n), scale, ratio)
        want = jax_ip.rrc_params(w, h, np.random.default_rng(n), scale, ratio)
        assert got == want, (w, h, n)
        i, j, ch, cw = got
        assert 0 <= i and i + ch <= h and 0 <= j and j + cw <= w
        fallbacks += (i, j) == ((h - ch) // 2, (w - cw) // 2)
    assert fallbacks > 5     # the central fallback ran too


def test_color_jitter_and_filters_equal_the_jax_package_s(rng):
    img = rng.integers(0, 256, (20, 24, 3)).astype(np.float32)
    for s in (0.1, 0.4, 1.5):
        np.testing.assert_array_equal(
            ip._color_jitter(img, np.random.default_rng(7), s),
            jax_ip._color_jitter(img, np.random.default_rng(7), s))
    for name in ("bilinear", "bicubic", "lanczos", "nearest", "random"):
        assert ip._pil_filter(name, np.random.default_rng(1)) == \
            jax_ip._pil_filter(name, np.random.default_rng(1))


# -- the unwired transforms --------------------------------------------------

def test_hsv_round_trip_equals_the_jax_package_s(rng):
    img = rng.integers(0, 256, (16, 20, 3)).astype(np.uint8)
    img[0, :3] = [[0, 0, 0], [255, 255, 255], [10, 10, 10]]     # grays: diff == 0
    hsv = extra.bgr2hsv_u8(img)
    np.testing.assert_array_equal(hsv, jax_extra.bgr2hsv_u8(img))
    np.testing.assert_array_equal(extra.hsv2bgr_u8(hsv), jax_extra.hsv2bgr_u8(hsv))


@pytest.mark.parametrize("seed", range(6))
def test_photometric_distortion_equals_the_jax_package_s(rng, seed):
    chw = rng.uniform(0, 255, (3, 12, 14)).astype(np.float32)
    got = extra.photometric_distortion(chw, np.random.default_rng(seed))
    want = jax_extra.photometric_distortion(chw, np.random.default_rng(seed))
    assert got.shape == (12, 14, 3) and got.dtype == np.uint8   # quirk 1: HWC out
    np.testing.assert_array_equal(got, want)


def test_event_jitter_and_fixed_resize_equal_the_jax_package_s(rng):
    x = rng.uniform(0, 10, (3, 9, 7)).astype(np.float32)
    np.testing.assert_array_equal(extra.event_jitter(x, np.random.default_rng(2), 0.2, 0.5),
                                  jax_extra.event_jitter(x, np.random.default_rng(2), 0.2, 0.5))
    for shape, factor in (((31, 45, 3), 2), ((31, 45), 2.5), ((16, 16, 2), 1.0)):
        img = rng.uniform(0, 255, shape).astype(np.float32)
        got = extra.fixed_resize(img, factor)
        np.testing.assert_array_equal(got, jax_extra.fixed_resize(img, factor))
        assert got.shape[:2] == (int(shape[0] / factor), int(shape[1] / factor))   # quirk 4
