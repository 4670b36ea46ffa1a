"""Matched trajectories: the port's production training (the runners of
mem_tpu_torch/tools/trajectory.py) against the JAX package's, step for step,
on the CPU, from one init and one seeded synthetic dataset. The JAX side is
built as scripts/parity_trajectory.py builds it (its module helpers imported
read-only) and runs the mem_tpu step builders its stage functions use.

The default run: stages A (pretraining) and B (the finetune from A's surgery) for
3 epochs at the reference test's gates (tests/test_parity_trajectory.py:
pretraining loss gap < 1e-4 relative with mlm-acc equal, finetune < 1e-3
with top-1 equal), the pretraining loss must fall by 0.1, and two planted
faults (the pretraining lr schedule read one step late; the head's
layer-decay group given block 0's scale) must fail their gates, rerun on the
port's side only against the JAX curves the module fixture holds.

Slow (``-m slow``): (a) all six stages for 20 epochs, each held at those
gates over its first 3 epochs, with onsets and final gaps reported; (b) the
finetune seed envelope (parity_finetune_envelope.py's method); (c) the bf16
drift envelope (parity_bf16_drift.py's method, 512 steps). Each has a
planted fault that must fail it.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import parity_trajectory as PT  # noqa: E402
from mem_tpu_torch.tools import trajectory as T  # noqa: E402
from mem_tpu_torch.train import optim as toptim  # noqa: E402
from mem_tpu_torch.utils.weights import (  # noqa: E402
    from_jax_params, mae_classifier_from_jax_params, mae_from_jax_params, seg_from_jax_params,
    vae_from_jax_params)

EPOCHS = 3
GATES = {"vae": 1e-4, "pretrain": 1e-4, "finetune": 1e-3, "seg": 1e-3, "mae": 1e-4,
         "mae_ft": 1e-3}
METRIC_GATE = 1e-6       # mlm-acc, top-1 (pts) and mIoU gaps
DRAW_KEYS = ("crop_tl", "ra_ops", "ra_bins", "ra_signs", "ra_batch_ops", "cj_brightness",
             "cj_saturation", "cj_order")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the tensors are small, and idle threads only spin
    against the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- the JAX side, as scripts/parity_trajectory.py builds it ---------------------

def _jb(batch):
    return jax.tree.map(jnp.asarray, {k: v for k, v in batch.items() if k not in DRAW_KEYS})


class JaxImages:
    """The jitted JAX preprocessing (the reference harness's twin input,
    parity_trajectory.py:234-245): the port's runners take it as their
    ``images`` feed."""

    def __init__(self, preproc):
        from mem_tpu.data.device_pipeline import preprocess_batch

        self.fns = {t: jax.jit(lambda b, t=t: preprocess_batch(b, preproc, is_train=t))
                    for t in (True, False)}

    def __call__(self, batch, is_train):
        return np.asarray(self.fns[is_train](_jb(batch)))


def _cosine(base, final, epochs, spe, warmup=None):
    from mem_tpu.train.schedules import cosine_scheduler

    total = epochs * spe
    return cosine_scheduler(base, final, epochs=epochs, niter_per_ep=spe,
                            warmup_steps=min(5, total // 4) if warmup is None else warmup)


def jax_tokenizer(dtype=jnp.float32):
    """Stage A's frozen VAE (parity_trajectory.py:203-212): one torch init,
    imported into flax."""
    from mem_tpu.models.discrete_vae import DiscreteVAE
    from mem_tpu.utils.torch_import import import_vae_state_dict
    from torch_twin import build_torch_vae

    torch.manual_seed(0)
    enc, dec, codebook = build_torch_vae(num_tokens=PT.VOCAB, codebook_dim=8, num_layers=3, R=1,
                                         hidden=16)
    sd = {f"encoder.{k}": v for k, v in enc.state_dict().items()}
    sd.update({f"decoder.{k}": v for k, v in dec.state_dict().items()})
    sd["codebook.weight"] = codebook.weight.detach()
    vae = DiscreteVAE(input_hw=(PT.IMG, PT.IMG), num_tokens=PT.VOCAB, codebook_dim=8,
                      num_layers=3, num_resnet_blocks=1, hidden_dim=16, dtype=dtype)
    params = jax.tree.map(jnp.asarray, import_vae_state_dict(sd, num_layers=3,
                                                             num_resnet_blocks=1))
    return vae, params


def jax_pretrain_init(init_key=0):
    _, pt_model, _ = PT.build_jax_stack(jnp)
    return jax.device_get(jax.jit(pt_model.init)(
        jax.random.key(init_key), jnp.zeros((1, PT.IMG, PT.IMG, 3)),
        jnp.zeros((1, PT.NPATCH), bool)))


def jax_pretrain(epochs, data_dir, params, vae, vae_params, steps=None, warmup=None):
    """Stage A's JAX arm (parity_trajectory.py:182-262; with ``steps``
    parity_bf16_drift.py's schedule)."""
    from mem_tpu.train.optim import create_optimizer
    from mem_tpu.train.schedules import as_schedule_fn
    from mem_tpu.train.steps import make_pretrain_train_step

    preproc, pt_model, _ = PT.build_jax_stack(jnp)
    it = PT.make_iterator(data_dir, True, masking=True)
    spe = it.steps_per_epoch()
    if steps is not None:
        epochs = -(-steps // spe)
    lr = _cosine(1e-3, 1e-5, epochs, spe, warmup)
    tx = create_optimizer(params, as_schedule_fn(lr), weight_decay=0.05, clip_grad=3.0)
    state = tx.init(params)
    jstep = make_pretrain_train_step(pt_model, vae, tx, preproc)
    loss, acc, t = [], [], 0
    for epoch in range(epochs):
        for batch in it.epoch(epoch):
            if steps is not None and t >= steps:
                break
            params, state, m = jstep(params, state, vae_params, _jb(batch),
                                     jax.random.key(1000 + t))
            loss.append(m["loss"])
            acc.append(m["mlm_acc"])
            t += 1
    return jax.device_get(params), {"loss": [float(v) for v in loss],
                                    "mlm_acc": [float(v) for v in acc]}


def _jax_eval_top1(jeval, params, val_it):
    c = n = 0
    for vb in val_it.epoch(0):
        bs = vb["label"].shape[0]
        c += float(jeval(params, _jb(vb))["acc1"]) / 100.0 * bs
        n += bs
    return 100.0 * c / n


def _jax_finetune_loop(model, params, epochs, data_dir, val_dir, seed_base):
    """Stages B and E's JAX arm (parity_trajectory.py:301-371, 507-570)."""
    from mem_tpu.train.optim import build_lr_scale_tree, build_wd_mask_tree, scheduled_adamw
    from mem_tpu.train.schedules import as_schedule_fn
    from mem_tpu.train.steps import make_finetune_eval_step, make_finetune_train_step

    preproc, _, _ = PT.build_jax_stack(jnp)
    it = PT.make_iterator(data_dir, True, masking=False)
    val_it = PT.make_iterator(val_dir, False, masking=False)
    lr = _cosine(4e-3, 1e-6, epochs, it.steps_per_epoch())
    tx = scheduled_adamw(as_schedule_fn(lr), (lambda s: 0.05),
                         build_lr_scale_tree(params, 0.9, PT.DEPTH), build_wd_mask_tree(params),
                         b1=0.9, b2=0.999, clip_grad=3.0)
    state = tx.init(params)
    jstep = make_finetune_train_step(model, tx, preproc, PT.NCLS, mixup_fn=None, smoothing=0.1)
    jeval = make_finetune_eval_step(model, preproc)
    loss, top1, t = [], [], 0
    for epoch in range(epochs):
        for batch in it.epoch(epoch):
            params, state, m = jstep(params, state, jax.tree.map(lambda x: x[None], _jb(batch)),
                                     jax.random.key(seed_base + t))
            loss.append(m["loss"])
            t += 1
        top1.append(_jax_eval_top1(jeval, params, val_it))
    return {"loss": [float(v) for v in loss], "top1": top1}


def jax_finetune(epochs, data_dir, val_dir, pt_params, init_key=5):
    from mem_tpu.utils.surgery import surgery_for_finetune

    _, _, ft_model = PT.build_jax_stack(jnp)
    ft_init = jax.device_get(jax.jit(ft_model.init)(jax.random.key(init_key),
                                                    jnp.zeros((1, PT.IMG, PT.IMG, 3))))
    params = surgery_for_finetune(pt_params, ft_init, dst_window=(PT.GRID, PT.GRID))
    return ft_init, _jax_finetune_loop(ft_model, params, epochs, data_dir, val_dir, 2000)


def port_finetune_init(init_key):
    """A finetune template from the JAX init of ``init_key``."""
    _, _, ft_model = PT.build_jax_stack(jnp)
    return from_jax_params(jax.device_get(jax.jit(ft_model.init)(
        jax.random.key(init_key), jnp.zeros((1, PT.IMG, PT.IMG, 3)))))


def _assert_gate(name, ref, got, steps=None):
    s = T.loss_gaps(ref["loss"][:steps], got["loss"][:steps])
    assert s["steps"] >= 6, s
    assert s["max_rel"] < GATES[name], (name, s)
    return s


def _dataset(tmp):
    train = T.make_dataset(os.path.join(tmp, "train"), seed=3)
    val = T.make_dataset(os.path.join(tmp, "val"), seed=11)
    return train, val


# -- stages A -> B ----------------------------------------------------------------

@pytest.fixture(scope="module")
def stages_ab(tmp_path_factory):
    """Stage A then stage B for 3 epochs on both sides (the port's B from its
    own A through its surgery), the JAX images fed to the port's hooks."""
    train_dir, val_dir = _dataset(str(tmp_path_factory.mktemp("traj")))
    preproc, _, _ = PT.build_jax_stack(jnp)
    images = JaxImages(preproc)
    vae, vae_params = jax_tokenizer()
    vae_state = vae_from_jax_params(jax.device_get(vae_params))
    init = jax_pretrain_init()
    jax_pt, want_a = jax_pretrain(EPOCHS, train_dir, init, vae, vae_params)
    ft_init, want_b = jax_finetune(EPOCHS, train_dir, val_dir, jax_pt)
    kw = dict(images=images, device="cpu")
    model, got_a = T.run_pretrain(train_dir, EPOCHS, from_jax_params(init), vae_state, **kw)
    _, got_b = T.run_finetune(train_dir, val_dir, EPOCHS, model.state_dict(),
                              from_jax_params(ft_init), **kw)
    return dict(dirs=(train_dir, val_dir), init=init, vae_state=vae_state, ft_init=ft_init,
                pt_state=model.state_dict(), images=images, want_a=want_a, got_a=got_a,
                want_b=want_b, got_b=got_b)


def test_pretrain_trajectory_matches_jax(stages_ab):
    s = _assert_gate("pretrain", stages_ab["want_a"], stages_ab["got_a"])
    acc = np.abs(np.subtract(stages_ab["want_a"]["mlm_acc"], stages_ab["got_a"]["mlm_acc"]))
    assert acc.max() < METRIC_GATE, (acc, s)


def test_finetune_trajectory_matches_jax(stages_ab):
    _assert_gate("finetune", stages_ab["want_b"], stages_ab["got_b"])
    top1 = np.abs(np.subtract(stages_ab["want_b"]["top1"], stages_ab["got_b"]["top1"]))
    assert len(top1) == EPOCHS and top1.max() < METRIC_GATE, top1


def test_training_actually_learns(stages_ab):
    for curves in (stages_ab["want_a"], stages_ab["got_a"]):
        assert curves["loss"][-1] < curves["loss"][0] - 0.1, curves["loss"]


def test_port_preprocessing_equals_the_fed_images(stages_ab):
    """The images fed to the port's view hooks are its own preprocessing's:
    every training and eval batch of the run, to f32 rounding."""
    from mem_tpu_torch.data.device_pipeline import preprocess_batch, with_train_draws
    from mem_tpu_torch.data.prefetch import to_device

    train_dir, val_dir = stages_ab["dirs"]
    pp = T.preproc()
    for data_dir, is_train in ((train_dir, True), (val_dir, False)):
        it = T.make_iterator(data_dir, is_train, masking=is_train)
        for batch in with_train_draws(it.epoch(0), pp):
            got = preprocess_batch(to_device(batch, "cpu"), pp, is_train).numpy()
            np.testing.assert_allclose(got, stages_ab["images"](batch, is_train), rtol=0,
                                       atol=1e-5)


def test_iterators_equal_the_jax_package_s(stages_ab):
    """The port's iterator hands out the reference's batches, array for
    array (masks, flips, shifts, seeds, events)."""
    train_dir, _ = stages_ab["dirs"]
    for epoch in range(2):
        mine = list(T.make_iterator(train_dir, True, masking=True).epoch(epoch))
        theirs = list(PT.make_iterator(train_dir, True, masking=True).epoch(epoch))
        assert len(mine) == len(theirs) == 2
        for a, b in zip(mine, theirs):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_planted_late_lr_fails_the_pretrain_gate(stages_ab, monkeypatch):
    """The cosine schedule shifted by one step (step t reads step t - 1's
    lr): the first step's update is unchanged (one-step gates cannot see
    it); the trajectory gate must."""
    real = T.cosine_scheduler

    def late(*a, **k):
        s = real(*a, **k)
        return np.concatenate([s[:1], s[:-1]])

    monkeypatch.setattr(T, "cosine_scheduler", late)
    _, got = T.run_pretrain(stages_ab["dirs"][0], EPOCHS, from_jax_params(stages_ab["init"]),
                            stages_ab["vae_state"], images=stages_ab["images"], device="cpu")
    s = T.loss_gaps(stages_ab["want_a"]["loss"], got["loss"])
    assert got["loss"][:2] == stages_ab["got_a"]["loss"][:2]
    assert s["max_rel"] >= GATES["pretrain"], s


def test_planted_layer_decay_fault_fails_the_finetune_gate(stages_ab, monkeypatch):
    """The head's group takes block 0's lr scale (its layer id read as
    block 0's): the first step's gradients are unchanged; the finetune gate
    must fail."""
    real = toptim.lr_scale

    def head_as_block0(name, layer_decay, num_layers):
        return real("blocks.0." + name if name.startswith("head.") else name, layer_decay,
                    num_layers)

    monkeypatch.setattr(toptim, "lr_scale", head_as_block0)
    train_dir, val_dir = stages_ab["dirs"]
    _, got = T.run_finetune(train_dir, val_dir, EPOCHS, stages_ab["pt_state"],
                            from_jax_params(stages_ab["ft_init"]), images=stages_ab["images"],
                            device="cpu")
    s = T.loss_gaps(stages_ab["want_b"]["loss"], got["loss"])
    assert got["loss"][0] == stages_ab["got_b"]["loss"][0]
    assert s["max_rel"] >= GATES["finetune"], s


# -- the reductions and the data against the scripts' own ----------------------

def test_datasets_are_the_harness_s(tmp_path):
    """make_dataset / make_seg_dataset write the reference harness's files
    byte for byte."""
    import filecmp

    for fn_mine, fn_theirs, kw in ((T.make_dataset, PT.make_dataset, dict(seed=3)),
                                   (T.make_seg_dataset, PT.make_seg_dataset, {})):
        a, b = str(tmp_path / f"a_{fn_mine.__name__}"), str(tmp_path / f"b_{fn_mine.__name__}")
        fn_mine(a, **kw)
        fn_theirs(b, **kw)
        files = sorted(os.path.relpath(os.path.join(d, f), a)
                       for d, _, fs in os.walk(a) for f in fs)
        assert files and files == sorted(os.path.relpath(os.path.join(d, f), b)
                                         for d, _, fs in os.walk(b) for f in fs)
        for f in files:
            assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False), f


def test_reductions_equal_the_scripts(rng):
    from parity_bf16_drift import window_stats
    from parity_finetune_envelope import smooth

    a = 2.0 + rng.random(230)
    b = a * (1 + 1e-3 * rng.standard_normal(230))
    np.testing.assert_array_equal(T.window_stats(a, b, 50), window_stats(a, b, 50))
    np.testing.assert_array_equal(T.smooth(a), smooth(a))
    np.testing.assert_array_equal(T.smooth(a[:3]), smooth(a[:3]))
    for thresh in (1e-4, 1e-2):
        assert T.onset(a, b, thresh) == PT._onset({"loss_jax": a, "loss_torch": b}, thresh)
    assert T.onset(a, a) == "never"
    s = T.loss_gaps(a, b)
    want = PT.summarize("x", {"loss_jax": a, "loss_torch": b})
    assert (s["max_abs"], s["max_rel"], s["mean_rel"]) == (
        want["max_abs_loss_delta"], want["max_rel_loss_delta"], want["mean_rel_loss_delta"])


def test_envelopes_pass_and_fail_as_the_scripts_decide(rng):
    """seed_envelope and drift_envelope on curves whose verdicts are known."""
    oracle = {"loss": list(1 + rng.random(40)), "top1": [50.0, 60.0, 70.0]}
    near = {"loss": [x + 0.01 for x in oracle["loss"]], "top1": [50.0, 60.0, 75.0]}
    far = {"loss": [x + 0.2 for x in oracle["loss"]], "top1": [40.0, 60.0, 90.0]}
    assert T.seed_envelope(oracle, near, [far])["pass"]
    assert not T.seed_envelope(oracle, far, [near])["pass"]
    o = 3 - np.linspace(0, 2, 200)
    r = T.drift_envelope(o, o, o * 1.01, o * 1.03)
    assert r["pass_envelope"] and r["pass_final"] and r["same_onset"] == "never"
    r = T.drift_envelope(o, o, o * 1.06, o * 1.03)
    assert not r["pass_envelope"] and not r["pass_final"]


# -- slow: (a) the six stages at 20 epochs --------------------------------------

def jax_vae(epochs, data_dir, vae_params):
    """Stage 0's JAX arm (parity_trajectory.py:100-179); also returns the
    Gumbel noise of each step, the harness's host draw."""
    import optax

    from mem_tpu.models.discrete_vae import DiscreteVAE
    from mem_tpu.train.schedules import VaeAnnealState
    from mem_tpu.train.steps import make_vae_train_step

    preproc, _, _ = PT.build_jax_stack(jnp)
    it = PT.make_iterator(data_dir, True, masking=False)
    vae = DiscreteVAE(input_hw=(PT.IMG, PT.IMG), num_tokens=PT.VOCAB, codebook_dim=8,
                      num_layers=3, num_resnet_blocks=1, hidden_dim=16)
    tx = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
    state, params = tx.init(vae_params), vae_params
    jstep = make_vae_train_step(vae, tx, preproc, inject_noise=True)
    sched = VaeAnnealState(1e-3, 0.99)
    hw = PT.IMG // 8
    nrng = np.random.default_rng(123)
    loss, noise = [], []
    for epoch in range(epochs):
        for i, batch in enumerate(it.epoch(epoch)):
            noise.append(T.gumbel_noise(nrng, (batch["n_valid"].shape[0], hw, hw, PT.VOCAB)))
            params, state, m = jstep(params, state, _jb(batch), jnp.asarray(noise[-1]),
                                     jnp.float32(sched.lr), jnp.float32(sched.temp),
                                     jnp.float32(1e-2))
            loss.append(m["loss"])
            sched.after_step(i)
    return {"loss": [float(v) for v in loss]}, noise


def _mae_noise(t):
    key = jax.random.key(2000 + t)
    return np.asarray(jax.random.uniform(jax.random.split(key)[0], (PT.B, PT.NPATCH)))


def jax_mae(epochs, data_dir):
    """Stage D's JAX arm (parity_trajectory.py:374-458)."""
    from mem_tpu.models.mae import MaskedAutoencoderViT
    from mem_tpu.train.optim import create_optimizer
    from mem_tpu.train.schedules import as_schedule_fn
    from mem_tpu.train.steps import make_mae_train_step

    preproc, _, _ = PT.build_jax_stack(jnp)
    it = PT.make_iterator(data_dir, True, masking=False)
    model = MaskedAutoencoderViT(img_size=PT.IMG, patch_size=PT.PATCH, embed_dim=PT.DIM,
                                 depth=PT.DEPTH, num_heads=PT.HEADS, **T.MAE_DECODER)
    init = jax.device_get(jax.jit(model.init)({"params": jax.random.key(0),
                                               "mask": jax.random.key(1)},
                                              jnp.zeros((1, PT.IMG, PT.IMG, 3))))
    lr = _cosine(1e-3, 1e-5, epochs, it.steps_per_epoch())
    tx = create_optimizer(init, as_schedule_fn(lr), weight_decay=0.05, clip_grad=3.0)
    params, state = init, tx.init(init)
    jstep = make_mae_train_step(model, tx, preproc)
    loss, t = [], 0
    for epoch in range(epochs):
        for batch in it.epoch(epoch):
            params, state, m = jstep(params, state, _jb(batch), jax.random.key(2000 + t))
            loss.append(m["loss"])
            t += 1
    return init, jax.device_get(params), {"loss": [float(v) for v in loss]}


def jax_mae_finetune(epochs, data_dir, val_dir, mae_params):
    from mem_tpu.models.mae_classifier import MAEVisionTransformer
    from mem_tpu.utils.surgery import surgery_for_mae_finetune

    model = MAEVisionTransformer(img_size=(PT.IMG, PT.IMG), patch_size=PT.PATCH,
                                 num_classes=PT.NCLS, embed_dim=PT.DIM, depth=PT.DEPTH,
                                 num_heads=PT.HEADS)
    init = jax.device_get(jax.jit(model.init)(jax.random.key(6),
                                              jnp.zeros((1, PT.IMG, PT.IMG, 3))))
    params = surgery_for_mae_finetune(mae_params, init)
    return init, _jax_finetune_loop(model, params, epochs, data_dir, val_dir, 4000)


def jax_seg(iters, data_root, eval_at, perturb=None, max_evs=4096, stop=None):
    """Stage C's JAX arm (parity_trajectory.py:600-725), the val split
    through the eval step after each iteration of ``eval_at``; ``perturb``
    (a numpy generator) scales every initial leaf by 1 + 1e-7 N(0, 1), f32
    rounding, to read the JAX package's own spread; ``max_evs`` and
    ``stop`` as ``T.run_seg``'s."""
    from mem_tpu.cli.train_seg import make_seg_steps, poly_lr_schedule
    from mem_tpu.data.seg_pipeline import SegBatchIterator, SegPipelineConfig, scan_seg_pairs
    from mem_tpu.models.segmentation import EncoderDecoder, seg_metrics
    from mem_tpu.train.optim import build_lr_scale_tree, build_wd_mask_tree, scheduled_adamw

    train_it = SegBatchIterator(scan_seg_pairs(data_root, "imgs/train", "anns/train"),
                                SegPipelineConfig(batch_size=T.SEG_B, is_train=True,
                                                  max_evs=max_evs, seed=13))
    val_it = SegBatchIterator(scan_seg_pairs(data_root, "imgs/val", "anns/val"),
                              SegPipelineConfig(batch_size=T.SEG_B, is_train=False,
                                                max_evs=max_evs, seed=13))
    model = EncoderDecoder(num_classes=T.SEG_NCLS, backbone_cfg=T.seg_backbone(),
                           dtype=jnp.float32, **T.SEG_HEADS)
    from mem_tpu.data.seg_pipeline import seg_preprocess_batch

    batches = train_it.batches()
    first = next(batches)
    imgs0, _ = jax.jit(lambda b: seg_preprocess_batch(b, True, False, False, y_sorted=True))(
        jax.tree.map(jnp.asarray, first))
    variables = jax.device_get(jax.jit(model.init)(jax.random.key(0), imgs0))
    if perturb is not None:
        variables = jax.tree.map(lambda x: (x * (1 + 1e-7 * perturb.standard_normal(x.shape)))
                                 .astype(np.float32), variables)
    params, stats = variables["params"], variables["batch_stats"]
    lr_fn = poly_lr_schedule(1e-3, iters, warmup_iters=max(2, iters // 8))
    wrapped = {"params": params}
    tx = scheduled_adamw(lr_fn, (lambda s: 0.05),
                         build_lr_scale_tree(wrapped, 0.65, T.SEG_DEPTH)["params"],
                         build_wd_mask_tree(wrapped)["params"], b1=0.9, b2=0.999, eps=1e-8)
    state = tx.init(params)
    train_step, eval_step = make_seg_steps(model, tx, T.SEG_NCLS, rand_aug=False, y_sorted=True)
    loss, miou, batch = [], [], first
    for t in range(iters if stop is None else stop):
        params, stats, state, m = train_step(params, stats, state,
                                             jax.tree.map(jnp.asarray, batch),
                                             jax.random.key(3000 + t))
        loss.append(m["loss"])
        if t + 1 in eval_at:
            cm = np.zeros((T.SEG_NCLS, T.SEG_NCLS))
            for vb in val_it.eval_batches():
                w = int(vb.pop("n_real")) / vb["label"].shape[0]
                cm += np.asarray(eval_step(params, stats, jax.tree.map(jnp.asarray, vb))) * w
            miou.append(float(seg_metrics(cm)["mIoU"]))
        batch = next(batches)
    return variables, {"loss": [float(v) for v in loss], "miou": miou}


# -- slow: the seg mIoU gate against the JAX package's own spread (ROADMAP S3) ----

SEG_ITERS, SEG_FIRST = 40, 6          # slow case (a)'s schedule and its reading point
SEG_SEEDS = 4                          # init perturbations of the JAX package's own spread
SEG_DATA = {"harness": ((2000, 4000), 4096),        # parity_trajectory.py's: blank eval images
            "dense": ((20_000, 30_000), 30_000)}    # 20k-30k events, none sliced away


def _late_poly(real):
    """The poly schedule read one iteration late (iteration t takes t - 1's lr)."""
    def late(*a, **k):
        fn = real(*a, **k)
        return lambda step: fn(max(int(step) - 1, 0))
    return late


@pytest.mark.slow
def test_seg_miou_against_the_jax_package_s_own_spread(tmp_path):
    """Stage C's first SEG_FIRST iterations (of the SEG_ITERS schedule) on
    the harness's synthetic DSEC set and on one with 20k-30k events a sample
    (eval images that are not blank): the port against the JAX package from
    one init, and the JAX package against itself from SEG_SEEDS inits
    perturbed at f32 rounding (1 + 1e-7 N(0, 1)). Writes
    seg_miou_spread.json in the test's tmp_path. Held: the dense set's eval
    images carry events, the seg loss gate (1e-3) on both sets, the port's
    harness-set mIoU gap inside the JAX package's own spread there, and the
    planted fault (the poly lr read one iteration late) outside ten times the
    JAX spread on the dense set. Slow: eleven JAX seg runs, about 4 minutes."""
    from mem_tpu_torch.data.seg_pipeline import (SegBatchIterator, SegPipelineConfig,
                                                 scan_seg_pairs, seg_preprocess_batch)

    report = {}
    for name, (events, max_evs) in SEG_DATA.items():
        root = T.make_seg_dataset(str(tmp_path / name), events=events)
        it = SegBatchIterator(scan_seg_pairs(root, "imgs/val", "anns/val"),
                              SegPipelineConfig(batch_size=T.SEG_B, is_train=False,
                                                max_evs=max_evs, seed=13))
        vb = next(iter(it.eval_batches()))
        vb.pop("n_real")
        imgs, _ = seg_preprocess_batch({k: torch.as_tensor(v) for k, v in vb.items()}, False,
                                       False, False, y_sorted=True)
        kw = dict(eval_at=(SEG_FIRST,), max_evs=max_evs, stop=SEG_FIRST)
        init, want = jax_seg(SEG_ITERS, root, **kw)
        _, got = T.run_seg(root, SEG_ITERS, seg_from_jax_params(init), device="cpu", **kw)
        own = [jax_seg(SEG_ITERS, root, perturb=np.random.default_rng(s), **kw)[1]["miou"][0]
               for s in range(SEG_SEEDS)]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(T, "poly_lr_schedule", _late_poly(T.poly_lr_schedule))
            _, fault = T.run_seg(root, SEG_ITERS, seg_from_jax_params(init), device="cpu", **kw)
        m = want["miou"][0]
        report[name] = dict(
            eval_image_nonzero=[float((im > 0).float().mean()) for im in imgs],
            loss=T.loss_gaps(want["loss"], got["loss"]), miou_jax=m, miou_port=got["miou"][0],
            miou_gap=abs(m - got["miou"][0]), jax_self_miou_gaps=[abs(m - o) for o in own],
            fault_loss=T.loss_gaps(want["loss"], fault["loss"]),
            fault_miou_gap=abs(m - fault["miou"][0]))
    _write(tmp_path / "seg_miou_spread.json", report)
    print(json.dumps(report, indent=1))

    h, d = report["harness"], report["dense"]
    assert max(h["eval_image_nonzero"]) == 0 and min(d["eval_image_nonzero"]) > 0.01
    for r in (h, d):
        assert r["loss"]["max_rel"] < GATES["seg"], r
    assert h["miou_gap"] <= max(h["jax_self_miou_gaps"]), h
    assert d["fault_miou_gap"] >= 10 * max(d["jax_self_miou_gaps"]), d


def _write(path, result):
    with open(path, "w") as f:
        json.dump(result, f, indent=1)


@pytest.mark.slow
def test_six_stages_twenty_epochs(tmp_path):
    """(a) The evidence run: every stage for 20 epochs (the seg stage 40
    iterations), each held at its gate over its first 3 epochs (6 steps),
    the eval metrics there too; the onsets and final gaps are printed and
    written to trajectory_six_stages.json in the test's tmp_path, beside
    the seg mIoU gap of the JAX package against itself from an init
    perturbed at f32 rounding.
    The planted fault (the VAE's anneal stepped on the global step instead
    of the within-epoch index) must fail the VAE gate."""
    epochs, first = 20, 6
    train_dir, val_dir = _dataset(str(tmp_path))
    seg_root = T.make_seg_dataset(str(tmp_path / "dsec"))
    preproc, _, _ = PT.build_jax_stack(jnp)
    images = JaxImages(preproc)
    kw = dict(device="cpu")
    want, got = {}, {}

    _, vae_params = jax_tokenizer()
    vae_state = vae_from_jax_params(jax.device_get(vae_params))
    want["vae"], gumbel = jax_vae(epochs, train_dir, vae_params)
    _, got["vae"] = T.run_vae(train_dir, epochs, vae_state, gumbel.__getitem__, images=images,
                              **kw)

    vae, tok_params = jax_tokenizer()
    tok_state = vae_from_jax_params(jax.device_get(tok_params))
    init = jax_pretrain_init()
    jax_pt, want["pretrain"] = jax_pretrain(epochs, train_dir, init, vae, tok_params)
    model, got["pretrain"] = T.run_pretrain(train_dir, epochs, from_jax_params(init), tok_state,
                                            images=images, **kw)
    ft_init, want["finetune"] = jax_finetune(epochs, train_dir, val_dir, jax_pt)
    _, got["finetune"] = T.run_finetune(train_dir, val_dir, epochs, model.state_dict(),
                                        from_jax_params(ft_init), images=images, **kw)

    mae_init, jax_mae_params, want["mae"] = jax_mae(epochs, train_dir)
    mae_model, got["mae"] = T.run_mae(train_dir, epochs, mae_from_jax_params(mae_init),
                                      _mae_noise, **kw)
    mft_init, want["mae_ft"] = jax_mae_finetune(epochs, train_dir, val_dir, jax_mae_params)
    _, got["mae_ft"] = T.run_mae_finetune(train_dir, val_dir, epochs, mae_model.state_dict(),
                                          mae_classifier_from_jax_params(mft_init),
                                          images=images, **kw)

    iters = 2 * epochs
    seg_init, want["seg"] = jax_seg(iters, seg_root, (first, iters))
    _, got["seg"] = T.run_seg(seg_root, iters, seg_from_jax_params(seg_init),
                              eval_at=(first, iters), **kw)

    report = {}
    for name in want:
        report[name] = dict(first=T.loss_gaps(want[name]["loss"][:first],
                                              got[name]["loss"][:first]),
                            full=T.loss_gaps(want[name]["loss"], got[name]["loss"]),
                            onset=T.onset(want[name]["loss"], got[name]["loss"]))
    report["pretrain"]["mlm_acc_gap_first"] = float(np.abs(np.subtract(
        want["pretrain"]["mlm_acc"][:first], got["pretrain"]["mlm_acc"][:first])).max())
    for name in ("finetune", "mae_ft"):
        d = np.abs(np.subtract(want[name]["top1"], got[name]["top1"]))
        report[name].update(top1_gap_first=float(d[:3].max()), top1_gap_full=float(d.max()))
    # the JAX package against itself from an init perturbed at f32 rounding
    _, own = jax_seg(iters, seg_root, (first, iters), perturb=np.random.default_rng(0))
    report["seg"].update(miou_gap_first=abs(want["seg"]["miou"][0] - got["seg"]["miou"][0]),
                         miou_gap_full=abs(want["seg"]["miou"][1] - got["seg"]["miou"][1]),
                         jax_self_miou_gap_first=abs(want["seg"]["miou"][0] - own["miou"][0]),
                         jax_self_miou_gap_full=abs(want["seg"]["miou"][1] - own["miou"][1]),
                         miou=[want["seg"]["miou"], got["seg"]["miou"], own["miou"]])

    # the planted fault: the anneal stepped on the global step
    from mem_tpu_torch.train import schedules

    real_after = schedules.VaeAnnealState.after_step
    counter = {"t": 0}

    def global_after(self, i):
        real_after(self, counter["t"])
        counter["t"] += 1

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(schedules.VaeAnnealState, "after_step", global_after)
        _, faulty = T.run_vae(train_dir, 3, vae_state, gumbel.__getitem__, images=images, **kw)
    report["fault_vae_global_step"] = T.loss_gaps(want["vae"]["loss"][:first],
                                                  faulty["loss"][:first])
    _write(tmp_path / "trajectory_six_stages.json", report)
    print(json.dumps(report, indent=1))

    for name in want:
        assert report[name]["first"]["steps"] >= first
        assert report[name]["first"]["max_rel"] < GATES[name], (name, report[name])
    assert report["pretrain"]["mlm_acc_gap_first"] < METRIC_GATE
    for name in ("finetune", "mae_ft"):
        assert report[name]["top1_gap_first"] < METRIC_GATE, (name, report[name])
    assert report["seg"]["miou_gap_first"] < METRIC_GATE, report["seg"]
    assert report["fault_vae_global_step"]["max_rel"] >= GATES["vae"], report


# -- slow: (b) the finetune seed envelope ----------------------------------------

@pytest.mark.slow
def test_finetune_seed_envelope(tmp_path):
    """(b) parity_finetune_envelope.py's method at 20 epochs: cross = the
    port against JAX from the same init (stage B after stage A, each side
    on its own stage A), seeds = 3 port-only runs with the finetune head
    redrawn (init keys 6, 7, 8). The cross smoothed-loss gap and top-1 gap
    must stay within the seed envelope (1x); the planted fault (the
    training labels read one class off, (label + 1) mod 4, as an off-by-one
    class index would give) must leave it."""
    epochs = 20
    train_dir, val_dir = _dataset(str(tmp_path))
    preproc, _, _ = PT.build_jax_stack(jnp)
    images = JaxImages(preproc)
    vae, tok_params = jax_tokenizer()
    tok_state = vae_from_jax_params(jax.device_get(tok_params))
    init = jax_pretrain_init()
    jax_pt, _ = jax_pretrain(epochs, train_dir, init, vae, tok_params)
    model, _ = T.run_pretrain(train_dir, epochs, from_jax_params(init), tok_state,
                              images=images, device="cpu")
    pt_state = model.state_dict()
    ft_init, cross = jax_finetune(epochs, train_dir, val_dir, jax_pt)

    def port(init_state):
        return T.run_finetune(train_dir, val_dir, epochs, pt_state, init_state, images=images,
                              device="cpu")[1]

    oracle = port(from_jax_params(ft_init))
    seeds = [port(port_finetune_init(k)) for k in (6, 7, 8)]
    result = T.seed_envelope(oracle, cross, seeds)

    from mem_tpu_torch.train import steps

    real = steps.finetune_cross_entropy
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(steps, "finetune_cross_entropy",
                   lambda logits, targets, k, *a, **kw: real(logits, (targets + 1) % k, k,
                                                             *a, **kw))
        faulty = port(from_jax_params(ft_init))
    result["fault_labels_one_class_off"] = T.seed_envelope(oracle, faulty, seeds)
    result["margin_loss"] = result["seed_envelope_loss_dev"] / result["cross_smoothed_loss_dev"]
    result["margin_top1"] = result["seed_envelope_top1_dev_pts"] / result["cross_top1_dev_pts"]
    result["top1"] = {"oracle": oracle["top1"], "cross": cross["top1"],
                      "seeds": [r["top1"] for r in seeds], "fault": faulty["top1"]}
    _write(tmp_path / "trajectory_finetune_envelope.json", result)
    print(json.dumps(result, indent=1))
    assert result["pass"], result
    assert not result["fault_labels_one_class_off"]["pass"], result


# -- slow: (c) the bf16 drift envelope --------------------------------------------

@pytest.mark.slow
def test_bf16_drift_envelope(tmp_path):
    """(c) parity_bf16_drift.py's method, 512 steps, window 50: the oracle
    is the JAX f32 pretraining; arm A the port in f32 from the same init,
    arm B the port in bf16 (model and tokenizer) from the same init, arm C
    the port in f32 from a redrawn init. B's largest windowed gap must be
    within C's and its final-window loss within 5 % of the oracle's; A's
    gap and onset are reported. The planted fault on B's step (the lr and
    wd schedules indexed by the epoch instead of the step, so each value
    holds for a whole epoch; the first step is exact) must fail the
    envelope. K2b's bias held from its first launch, the card's fault
    (tools/trajectory_faults.py), is reported beside it."""
    from mem_tpu_torch.tools.trajectory_faults import bias_held_from_first_launch
    from mem_tpu_torch.train import steps as tsteps

    steps = 512
    train_dir, _ = _dataset(str(tmp_path))
    vae, tok_params = jax_tokenizer()
    tok_state = vae_from_jax_params(jax.device_get(tok_params))
    init = jax_pretrain_init()
    _, oracle = jax_pretrain(0, train_dir, init, vae, tok_params, steps=steps, warmup=10)

    def port(state, dtype=torch.float32):
        return T.run_pretrain(train_dir, 0, state, tok_state, steps=steps, warmup_steps=10,
                              dtype=dtype, device="cpu")[1]["loss"]

    same = port(from_jax_params(init))
    low = port(from_jax_params(init), torch.bfloat16)
    redrawn = port(from_jax_params(jax_pretrain_init(1)))
    result = T.drift_envelope(oracle["loss"], same, low, redrawn)
    spe = T.make_iterator(train_dir, True, masking=True).steps_per_epoch()
    real = tsteps.at
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsteps, "at", lambda schedule, it: real(schedule, int(it) // spe))
        by_epoch = port(from_jax_params(init), torch.bfloat16)
    with bias_held_from_first_launch():
        stale = port(from_jax_params(init), torch.bfloat16)
    result["fault_schedule_by_epoch"] = T.drift_envelope(oracle["loss"], same, by_epoch, redrawn)
    result["bias_held_from_first_launch"] = T.drift_envelope(oracle["loss"], same, stale,
                                                             redrawn)
    result["margin"] = result["seed_run_to_run_dev"] / result["max_windowed_rel_dev_low"]
    _write(tmp_path / "trajectory_bf16_drift.json",
           {**result, "oracle": oracle["loss"], "same": same, "low": low, "redrawn": redrawn,
            "schedule_by_epoch": by_epoch, "stale_bias": stale})
    print(json.dumps({k: v for k, v in result.items() if not k.endswith("dev")}, indent=1))
    assert result["pass_final"] and result["pass_envelope"], result
    f = result["fault_schedule_by_epoch"]
    assert not (f["pass_final"] and f["pass_envelope"]), f
