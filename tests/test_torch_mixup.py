"""Mixup / CutMix of the port (train/mixup.py) held against
mem_tpu/train/mixup.py. The two draw from different generators, so the
tests draw the reference's own parameters from its key (the key splits of
mixup.py:104-116 / :126-138 and the module-level ``_rand_bbox`` /
``_rand_bbox_minmax``), hand them to the port's mix function, and compare
images and soft targets with what the reference makes of the same key. The
host draws' distributions are checked by their moments."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mem_tpu.train import mixup as jax_mixup
from mem_tpu_torch.train import mixup as M

K, H, W = 7, 12, 10


def _jax_draws(key, cfg: M.MixupConfig, B: int) -> dict:
    """The reference's parameters for ``key``, as the port's draws dict."""
    def one(k):
        k_use, k_switch, k_lam, k_box = jax.random.split(k, 4)
        use = bool(jax.random.uniform(k_use) < cfg.prob)
        if cfg.mixup_alpha > 0 and cfg.cutmix_on:
            use_cutmix = bool(jax.random.uniform(k_switch) < cfg.switch_prob)
        else:
            use_cutmix = cfg.cutmix_on
        lam_mix = jax.random.beta(k_lam, cfg.mixup_alpha or 1.0, cfg.mixup_alpha or 1.0)
        lam_cut = jax.random.beta(k_lam, cfg.cutmix_alpha or 1.0, cfg.cutmix_alpha or 1.0)
        if cfg.cutmix_minmax is not None:
            *box, lam_adj = jax_mixup._rand_bbox_minmax(k_box, H, W, cfg.cutmix_minmax)
        else:
            *box, lam_adj = jax_mixup._rand_bbox(k_box, H, W, lam_cut)
        return use, use_cutmix, float(lam_mix), [int(b) for b in box], float(lam_adj)

    n = {"batch": 1, "elem": B, "pair": B // 2}[cfg.mode]
    rows = [one(key)] if cfg.mode == "batch" else [one(k) for k in jax.random.split(key, n)]
    use = np.array([r[0] for r in rows], bool)
    uc = np.array([r[1] for r in rows], bool)
    lam_mix = np.array([r[2] for r in rows], np.float32)
    box = np.array([r[3] for r in rows], np.int32).reshape(n, 4)
    lam = np.where(use, np.where(uc, np.array([r[4] for r in rows], np.float32), lam_mix),
                   np.float32(1.0)).astype(np.float32)
    lam_img = lam_mix if cfg.mode == "batch" else lam
    if cfg.mode == "batch":
        use, uc, lam, lam_img, box = (np.repeat(a, B, axis=0)
                                      for a in (use, uc, lam, lam_img, box))
    elif cfg.mode == "pair":
        mir = lambda v, mid: np.concatenate(
            [v, np.full((B % 2,) + v.shape[1:], mid, v.dtype), v[::-1]])
        use, uc, lam, lam_img, box = (mir(use, False), mir(uc, False), mir(lam, 1.0),
                                      mir(lam_img, 1.0), mir(box, 0))
    return {"mix_use": use, "mix_use_cutmix": uc, "mix_lam": lam, "mix_lam_img": lam_img,
            "mix_box": box}


@pytest.mark.parametrize("minmax", [None, (0.2, 0.8)], ids=["beta_box", "cutmix_minmax"])
@pytest.mark.parametrize("mode,B", [("batch", 6), ("elem", 6), ("pair", 6), ("pair", 5)])
def test_mix_equals_reference_given_its_draws(rng, mode, B, minmax):
    """Images and soft targets to 1e-6, over several keys so that mixup rows,
    cutmix rows and unused rows all occur."""
    kw = dict(mixup_alpha=0.8, cutmix_alpha=1.0, prob=0.8, switch_prob=0.5,
              label_smoothing=0.1, mode=mode, cutmix_minmax=minmax)
    fn = jax_mixup.make_mixup(K, **kw)
    cfg = M.make_mixup(K, **kw)
    images = rng.random((B, H, W, 3)).astype(np.float32)
    targets = rng.integers(0, K, B).astype(np.int32)
    seen = set()
    for seed in range(6):
        key = jax.random.key(seed)
        want_img, want_soft = fn(key, jnp.asarray(images), jnp.asarray(targets))
        draws = _jax_draws(key, cfg, B)
        seen |= {(bool(u), bool(c)) for u, c in zip(draws["mix_use"], draws["mix_use_cutmix"])}
        got_img, got_soft = M.mixup_apply(torch.from_numpy(images), torch.from_numpy(targets),
                                          {k: torch.from_numpy(v) for k, v in draws.items()},
                                          cfg)
        np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), atol=1e-6)
        np.testing.assert_allclose(got_soft.numpy(), np.asarray(want_soft), atol=1e-6)
        np.testing.assert_allclose(got_soft.sum(-1).numpy(), 1.0, atol=1e-6)
    assert {(True, True), (True, False)} <= seen


@pytest.mark.parametrize("kw", [dict(mixup_alpha=0.0, cutmix_alpha=1.0),
                                dict(mixup_alpha=0.8, cutmix_alpha=0.0)],
                         ids=["cutmix_only", "mixup_only"])
def test_single_method_settings_equal_reference(rng, kw):
    kw = dict(prob=1.0, switch_prob=0.5, label_smoothing=0.0, mode="elem", **kw)
    fn, cfg = jax_mixup.make_mixup(K, **kw), M.make_mixup(K, **kw)
    images = rng.random((4, H, W, 3)).astype(np.float32)
    targets = rng.integers(0, K, 4).astype(np.int32)
    key = jax.random.key(11)
    want_img, want_soft = fn(key, jnp.asarray(images), jnp.asarray(targets))
    draws = _jax_draws(key, cfg, 4)
    assert draws["mix_use_cutmix"].all() == (kw["mixup_alpha"] == 0.0)
    got_img, got_soft = M.mixup_apply(torch.from_numpy(images), torch.from_numpy(targets),
                                      {k: torch.from_numpy(v) for k, v in draws.items()}, cfg)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), atol=1e-6)
    np.testing.assert_allclose(got_soft.numpy(), np.asarray(want_soft), atol=1e-6)


def test_make_mixup_is_off_and_checks_like_the_reference():
    for kw in (dict(prob=0.0), dict(mixup_alpha=0.0, cutmix_alpha=0.0)):
        assert M.make_mixup(K, **kw) is None and jax_mixup.make_mixup(K, **kw) is None
    assert M.make_mixup(K, mixup_alpha=0.0, cutmix_alpha=0.0, cutmix_minmax=(0.2, 0.5)).cutmix_on
    with pytest.raises(ValueError, match="batch\\|pair\\|elem"):
        M.make_mixup(K, mode="half")
    with pytest.raises(ValueError, match="exactly 2"):
        M.make_mixup(K, cutmix_minmax=(0.1, 0.2, 0.3))


def test_host_draws_have_the_reference_s_distributions():
    """Moments over 4,000 per-sample draws: the use and switch coins at
    their probabilities (+-0.03), the mixup lambda Beta(0.8, 0.8) (mean 0.5,
    variance 1 / (4 (2a + 1)) = 0.0962, +-0.01), a cutmix row's lambda
    equal to the share of the image outside its box, boxes inside the
    image, unused rows with lambda 1."""
    cfg = M.make_mixup(K, 0.8, 1.0, prob=0.7, switch_prob=0.3, mode="elem")
    d = M.draw_mixup(cfg, 123, 4000, 64, 48)
    assert set(d) == set(M.MIXUP_KEYS)
    use, uc, lam, box = d["mix_use"], d["mix_use_cutmix"], d["mix_lam"], d["mix_box"]
    assert abs(use.mean() - 0.7) < 0.03 and abs(uc.mean() - 0.3) < 0.03
    mix_rows = use & ~uc
    assert abs(lam[mix_rows].mean() - 0.5) < 0.03
    assert abs(lam[mix_rows].var() - 1.0 / (4 * (2 * 0.8 + 1))) < 0.01
    assert (lam[~use] == 1.0).all()
    assert (box[:, 0] >= 0).all() and (box[:, 1] <= 64).all() and (box[:, 3] <= 48).all()
    assert (box[:, 0] <= box[:, 1]).all() and (box[:, 2] <= box[:, 3]).all()
    area = (box[:, 1] - box[:, 0]) * (box[:, 3] - box[:, 2]) / (64.0 * 48.0)
    np.testing.assert_allclose(lam[use & uc], 1.0 - area[use & uc], atol=1e-6)
    # Beta(1, 1) cutmix lambdas: the box covers 1 - lam of the image before
    # clipping, so the mean uncut share sits above 0.5
    assert 0.5 < lam[use & uc].mean() < 0.75


def test_host_draws_modes_and_minmax():
    cfg = M.make_mixup(K, 0.8, 1.0, prob=1.0, mode="batch")
    d = M.draw_mixup(cfg, 5, 6, 32, 32)
    assert all(len(set(map(float, np.asarray(d[k]).reshape(6, -1).sum(1)))) == 1
               for k in ("mix_lam", "mix_lam_img")) and (d["mix_box"] == d["mix_box"][0]).all()
    cfg = M.make_mixup(K, 0.8, 1.0, prob=1.0, mode="pair")
    d = M.draw_mixup(cfg, 5, 7, 32, 32)
    assert not d["mix_use"][3] and d["mix_lam"][3] == 1.0           # the odd middle row
    for k in M.MIXUP_KEYS:
        np.testing.assert_array_equal(d[k], d[k][::-1])               # (i, B-1-i) share
    cfg = M.make_mixup(K, 0.0, 0.0, prob=1.0, mode="elem", cutmix_minmax=(0.25, 0.5))
    d = M.draw_mixup(cfg, 9, 500, 40, 40)
    side_h = (d["mix_box"][:, 1] - d["mix_box"][:, 0]) / 40.0
    assert d["mix_use_cutmix"].all() and side_h.min() >= 0.25 - 1 / 40 and side_h.max() <= 0.5
    # same seed, same draws; another seed, other draws
    np.testing.assert_array_equal(M.draw_mixup(cfg, 9, 500, 40, 40)["mix_box"], d["mix_box"])
    assert (M.draw_mixup(cfg, 10, 500, 40, 40)["mix_box"] != d["mix_box"]).any()
