"""The port's DSEC segmentation pipeline held against the JAX package's on one
synthetic dataset: the host batches (numpy and native loaders, evaluation and
training iterators) array for array, and the device-side evaluation
preprocessing exactly, in f32."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mem_tpu.data import seg_pipeline as jsp
from mem_tpu_torch import native
from mem_tpu_torch.data import seg_pipeline as tsp


@pytest.fixture(scope="module")
def synth_seg_dataset(tmp_path_factory):
    """The recipe of tests/test_segmentation.py's fixture of the same name:
    (events .npy, label .png) pairs, y up to 480 so that the crop at 440
    bites, an ignore band in the labels; one recording above the event cap."""
    from PIL import Image

    root = tmp_path_factory.mktemp("dsec")
    rng = np.random.default_rng(5)
    for split, n in (("train", 6), ("val", 3)):
        (root / "imgs" / split / "seq0").mkdir(parents=True)
        (root / "anns" / split / "seq0").mkdir(parents=True)
        for i in range(n):
            ne = int(rng.integers(2000, 5000)) if i else 7000
            ev = np.zeros((ne, 4), np.float32)
            ev[:, 0] = rng.integers(0, 640, ne)
            ev[:, 1] = rng.integers(0, 480, ne)
            ev[:, 3] = rng.integers(0, 2, ne)
            np.save(root / "imgs" / split / "seq0" / f"{i:06d}.npy", ev)
            lab = rng.integers(0, 3, (440, 640)).astype(np.uint8)
            lab[:10] = 255
            Image.fromarray(lab).save(root / "anns" / split / "seq0" / f"{i:06d}.png")
    return str(root)


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _iterators(root, split, **cfg):
    pairs = tsp.scan_seg_pairs(root, f"imgs/{split}", f"anns/{split}")
    assert pairs == jsp.scan_seg_pairs(root, f"imgs/{split}", f"anns/{split}")
    return (tsp.SegBatchIterator(pairs, tsp.SegPipelineConfig(**cfg)),
            jsp.SegBatchIterator(pairs, jsp.SegPipelineConfig(**cfg)))


def test_constants_and_label_loader(synth_seg_dataset):
    assert (tsp.SEG_H, tsp.SEG_W, tsp.SEG_MAX_EVS, tsp.IGNORE_INDEX) == \
        (jsp.SEG_H, jsp.SEG_W, jsp.SEG_MAX_EVS, jsp.IGNORE_INDEX)
    _, ann = tsp.scan_seg_pairs(synth_seg_dataset, "imgs/val", "anns/val")[0]
    lab = tsp.load_seg_label(ann)
    assert lab.dtype == np.uint8 and lab.shape == (440, 640)
    np.testing.assert_array_equal(lab, jsp.load_seg_label(ann))
    with pytest.raises(FileNotFoundError):
        tsp.scan_seg_pairs(synth_seg_dataset, "imgs/none", "anns/none")


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("presort_y", [True, False])
def test_eval_batches_equal_jax(synth_seg_dataset, use_native, presort_y):
    """3 pairs at batch 2: a full batch and a padded one (the last index
    duplicated, n_real 1); a 5,000-event cap that one recording exceeds."""
    if use_native and not native.available():
        pytest.skip("no g++: the native loader cannot be built")
    tit, jit_ = _iterators(synth_seg_dataset, "val", batch_size=2, is_train=False,
                           max_evs=5000, presort_y=presort_y, use_native=use_native)
    assert tit._native_eligible() == (use_native and presort_y)
    got, want = list(tit.eval_batches()), list(jit_.eval_batches())
    assert len(got) == len(want) == 2
    assert [int(b["n_real"]) for b in got] == [2, 1]
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
    assert got[0]["events_xyp"].dtype == np.int16
    assert int(got[0]["n_valid"].max()) == 5000          # the over-cap recording
    ys = got[0]["events_xyp"][0, : got[0]["n_valid"][0], 1]
    assert ys.max() < 440 and (not presort_y or bool((np.diff(ys) >= 0).all()))


def test_native_and_python_eval_batches_agree(synth_seg_dataset):
    """Under the cap the two loaders give the same events (the over-cap
    window start is drawn from different streams, as in the reference)."""
    if not native.available():
        pytest.skip("no g++: the native loader cannot be built")
    a, _ = _iterators(synth_seg_dataset, "val", batch_size=2, is_train=False,
                      max_evs=8000, use_native=True)
    b, _ = _iterators(synth_seg_dataset, "val", batch_size=2, is_train=False,
                      max_evs=8000, use_native=False)
    for g, w in zip(a.eval_batches(), b.eval_batches()):
        np.testing.assert_array_equal(g["n_valid"], w["n_valid"])
        # both sort by y; events of one row may come in another order
        np.testing.assert_array_equal(g["events_xyp"][..., 1], w["events_xyp"][..., 1])
        for a, b in zip(g["events_xyp"], w["events_xyp"]):
            np.testing.assert_array_equal(a[np.lexsort(a.T[::-1])], b[np.lexsort(b.T[::-1])])
        np.testing.assert_array_equal(g["label"], w["label"])


@pytest.mark.parametrize("compact_wire", [True, False])
def test_train_batches_equal_jax(synth_seg_dataset, compact_wire):
    """The training iterator is the same host code (flips, aug seeds and the
    resize jitter drawn per (seed, iter, index)); the device side of training
    is held in tests/test_torch_seg_train.py."""
    tit, jit_ = _iterators(synth_seg_dataset, "train", batch_size=4, is_train=True,
                           max_evs=5000, seed=3, use_native=False, compact_wire=compact_wire)
    tb, jb = tit.batches(), jit_.batches()
    for _ in range(2):
        g = next(tb)
        _assert_batches_equal(g, next(jb))
    assert g["resize_jitter"].shape == (4, 4) and ("events_xyp" in g) == compact_wire


@pytest.mark.parametrize("y_sorted", [True, False])
def test_seg_preprocess_batch_eval_equals_jax(rng, y_sorted):
    """voxelize 440x640 -> hot-pixel removal -> /max * 255, f32: exact.
    30,000 events a sample: with a few thousand the hot-pixel threshold
    (mean + 10 std of the counts) falls below one count and the image is
    all zeros."""
    B, N = 2, 30000
    xyp = np.zeros((B, N, 3), np.int16)
    xyp[..., 0] = rng.integers(0, 640, (B, N))
    xyp[..., 1] = rng.integers(0, 440, (B, N))
    if y_sorted:
        xyp[..., 1] = np.sort(xyp[..., 1], axis=1)
    xyp[..., 2] = rng.choice([-1, 1], (B, N))
    xyp[0, :400, :2] = (9, 0)                      # a hot pixel: > 255 hits, the uint8 wrap
    xyp[1, 21000:] = 0                             # the zero pad past n_valid
    batch = {"events_xyp": xyp, "n_valid": np.array([N, 21000], np.int32),
             "label": rng.integers(0, 3, (B, 440, 640)).astype(np.int32)}
    want_img, want_lab = jsp.seg_preprocess_batch(
        {k: jnp.asarray(v) for k, v in batch.items()}, False, y_sorted=y_sorted)
    img, lab = tsp.seg_preprocess_batch({k: torch.from_numpy(v) for k, v in batch.items()},
                                        False, y_sorted=y_sorted)
    assert img.dtype == torch.float32 and img.shape == (B, 440, 640, 3)
    np.testing.assert_array_equal(img.numpy(), np.asarray(want_img))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(want_lab))
    assert img.max().item() == 255.0 and img[..., 1].abs().max().item() == 0.0
    assert int((img > 0).sum()) > 20000 and img[0, 0, 9].abs().max().item() == 0.0
    # a label-free batch (serving) returns labels None
    batch.pop("label")
    assert tsp.seg_preprocess_batch({k: torch.from_numpy(v) for k, v in batch.items()},
                                    False)[1] is None


def test_seg_preprocess_batch_train_raises(rng):
    """Training with RandAugment needs the host draws in the batch."""
    batch = {"events_xyp": torch.zeros(1, 100, 3, dtype=torch.int16),
             "n_valid": torch.tensor([100], dtype=torch.int32),
             "label": torch.zeros(1, 440, 640, dtype=torch.int32),
             "flip": torch.tensor([False])}
    with pytest.raises(ValueError, match="draw_seg_train_aug"):
        tsp.seg_preprocess_batch(batch, True, rand_aug=True)
