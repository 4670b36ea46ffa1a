"""The port's host feed held against the JAX package: the masking
generators, EventBatchIterator batches (python and native loaders, the
compact wire, the mask pool) array for array, the prefetch helpers, and the
cosine schedules."""
import argparse

import numpy as np
import pytest
import torch

from mem_tpu.cli import common as jax_common
from mem_tpu.data.pipeline import EventBatchIterator as JaxIterator
from mem_tpu.data.pipeline import PipelineConfig as JaxConfig
from mem_tpu.ops import masking as jax_masking
from mem_tpu.train.schedules import cosine_scheduler as jax_cosine_scheduler
from mem_tpu_torch.cli import common
from mem_tpu_torch.data import prefetch as pf
from mem_tpu_torch.data.pipeline import EventBatchIterator, PipelineConfig
from mem_tpu_torch.ops import masking
from mem_tpu_torch.train.schedules import cosine_scheduler


@pytest.mark.parametrize("kind,kw", [("block", dict(min_num_patches=4)),
                                     ("block", dict(min_num_patches=16, max_num_patches=30)),
                                     ("random", {})])
def test_mask_generators_equal(kind, kw):
    want = jax_masking.make_mask_generator(kind, (14, 14), 75, **kw)
    got = masking.make_mask_generator(kind, (14, 14), 75, **kw)
    for seed in range(5):
        np.testing.assert_array_equal(got(np.random.default_rng(seed)),
                                      want(np.random.default_rng(seed)))


@pytest.fixture
def npy_folder(tmp_path):
    rng = np.random.default_rng(1)
    root = tmp_path / "ncaltech101"
    for split, n in (("train", 11), ("val", 5)):
        for i in range(n):
            d = root / split / f"c{i % 3}"
            d.mkdir(parents=True, exist_ok=True)
            m = int(rng.integers(50, 900))
            ev = np.zeros((m, 4))
            ev[:, 0] = rng.integers(0, 60, m)
            ev[:, 1] = rng.integers(0, 45, m)
            ev[:, 2] = np.sort(rng.integers(0, 10**5, m))
            ev[:, 3] = rng.choice([-1.0, 1.0], m)
            np.save(d / f"s{i}.npy", ev)
    return str(root)


def _args(data_path, compact):
    p = argparse.ArgumentParser()
    common.add_preprocessing_args(p)
    a = p.parse_args([])
    a.data_path = data_path
    a.slice_max_evs = 500
    a.max_random_shift_evs = 4
    a.compact_wire = compact
    a.num_mask_patches = 20
    a.mask_pool_size = 8
    return a


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("compact", [1, 0])
@pytest.mark.parametrize("split", ["train", "val"])
def test_event_batch_iterator_batches_equal(npy_folder, native, compact, split):
    args = _args(npy_folder, compact)
    kw = dict(masking="block", window_size=(8, 8), seed=3, num_workers=2)
    is_train = split == "train"
    _, want_it = jax_common.build_pipeline(args, split, is_train, 4, **kw)
    _, got_it = common.build_pipeline(args, split, is_train, 4, **kw)
    assert isinstance(got_it, EventBatchIterator)
    want_it.cfg.use_native = got_it.cfg.use_native = native
    from mem_tpu import native as libmemev

    assert got_it._native_eligible() == (native and libmemev.available())
    assert got_it.steps_per_epoch() == want_it.steps_per_epoch()
    for epoch in (0, 1):
        want, got = list(want_it.epoch(epoch)), list(got_it.epoch(epoch))
        assert len(got) == len(want) > 0
        for gb, wb in zip(got, want):
            assert set(gb) == set(wb)
            for k in wb:
                assert gb[k].dtype == wb[k].dtype, k
                np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)


def test_pipeline_config_fields_equal():
    import dataclasses

    assert ([(f.name, f.default) for f in dataclasses.fields(PipelineConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(JaxConfig)])
    assert JaxIterator.__init__.__code__.co_varnames[:3] == \
        EventBatchIterator.__init__.__code__.co_varnames[:3]


def test_prefetch_helpers():
    items = [{"a": np.full((2,), i, np.float32), "s": np.array([i], np.uint32)} for i in range(5)]
    assert [int(b["a"][0]) for b in pf.prefetch(iter(items), depth=2)] == list(range(5))
    chunks = list(pf.chunk_batches(iter(items), 2))
    assert [c["a"].shape for c in chunks] == [(2, 2), (2, 2), (1, 2)]
    out = list(pf.device_prefetch(iter(items), "cpu"))
    assert out[3]["s"].dtype == torch.int64 and out[3]["a"].tolist() == [3.0, 3.0]
    d = pf.to_device({"ra_batch_ops": np.array([1, 2]), "x": np.zeros(2)}, "cpu")
    assert isinstance(d["ra_batch_ops"], np.ndarray) and isinstance(d["x"], torch.Tensor)


@pytest.mark.parametrize("kw", [dict(warmup_epochs=2), dict(warmup_steps=7),
                                dict(warmup_epochs=0), dict(start_warmup_value=1e-6,
                                                            warmup_epochs=1)])
def test_cosine_scheduler_equal(kw):
    want = jax_cosine_scheduler(5e-4, 1e-5, 6, 5, **kw)
    got = cosine_scheduler(5e-4, 1e-5, 6, 5, **kw)
    np.testing.assert_array_equal(got, want)
