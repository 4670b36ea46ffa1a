"""Chained dispatch of the port (mem_tpu_torch/train/chain.py,
``--steps_per_dispatch K``) on the CPU, where a chain is its eager loop, at
the size of tests/test_steps_chained.py (K=3, 32^2 inputs, patch 8 or 4,
depth 2):

(a) each stage's chain against the JAX package's ``chain=True`` step on the
    same weights and blocks (dropout and drop-path 0; the MAE's shuffle
    noise and the VAE's Gumbel noise the JAX chain's own, carried in the
    block): the stacked losses and grad norms and the final parameters to
    the tolerance of that stage's step-at-a-time port-vs-JAX test;
(b) each stage's chain against K single port steps driven with the chunk's
    generator (dropout, drop-path and the noises on), bit-equal;
(c) the device-side batch op of RandAugment against the host branch, each
    of the 14 ops, bit-equal; the graph form's optimizer arithmetic
    (optim.DeviceSchedule) against the stock update, with planted faults;
(d) train_seg at K=3 with an eval interval of 4 evaluates at the
    reference's iterations; train_vae at K=3 logs the anneal's lr of every
    step;
(e) a K=3 pretraining run recycled at every epoch boundary (a tail chunk
    each epoch) is bit-equal to a straight K=3 run;
(f) K=1 reproduces the step-at-a-time losses the port gave before chains.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mem_tpu.cli import train_seg as jax_train_seg
from mem_tpu.data.device_pipeline import PreprocConfig as JaxPreprocConfig
from mem_tpu.models.discrete_vae import DiscreteVAE as JaxDiscreteVAE
from mem_tpu.models.mae import MaskedAutoencoderViT as JaxMAE
from mem_tpu.train import optim as jax_optim
from mem_tpu.train.schedules import as_schedule_fn
from mem_tpu.train.steps import make_finetune_train_step as jax_finetune_step
from mem_tpu.train.steps import make_mae_train_step as jax_mae_step
from mem_tpu.train.steps import make_pretrain_train_step as jax_pretrain_step
from mem_tpu.train.steps import make_vae_train_step as jax_vae_step
from mem_tpu_torch.data.device_pipeline import PreprocConfig, draw_train_aug
from mem_tpu_torch.models import mae
from mem_tpu_torch.models.discrete_vae import DiscreteVAE
from mem_tpu_torch.models.registry import create_model
from mem_tpu_torch.ops import rand_augment as ra
from mem_tpu_torch.train import optim
from mem_tpu_torch.train import steps as S
from mem_tpu_torch.train.chain import chunk_seed
from mem_tpu_torch.train.schedules import VaeAnnealState, cosine_scheduler, poly_lr_schedule
from mem_tpu_torch.utils.weights import (from_jax_params, mae_from_jax_params,
                                         seg_from_jax_params, vae_from_jax_params)
from test_torch_recycle import exact_flags, run_arm
from test_torch_seg_train import NUM_CLASSES, _SIZE, _as_torch, _seg_batch, _segmentors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 3
HW = 32
B = 2
LR = cosine_scheduler(1e-3, 1e-4, 1, K)
WD = cosine_scheduler(0.05, 0.2, 1, K)
_PP = dict(input_h=HW, input_w=HW, canvas_h=HW, canvas_w=HW, rand_aug=False, color_jitter=0.0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: the bit-equal cases then sum in one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _events(rng, n, mask=False, label=False, N=300):
    out = []
    for _ in range(n):
        ev = np.zeros((B, N, 4), np.float32)
        ev[..., 0] = rng.integers(0, HW, (B, N))
        ev[..., 1] = rng.integers(0, HW, (B, N))
        ev[..., 2] = np.sort(rng.integers(0, 10**6, (B, N)), axis=1)
        ev[..., 3] = rng.choice([-1.0, 1.0], (B, N))
        b = {"events": ev, "n_valid": np.array([N, 200], np.int32),
             "sample_h": np.array([HW, 28], np.int32), "sample_w": np.array([HW, 30], np.int32),
             "time_flip": rng.random(B) < 0.5, "x_flip": rng.random(B) < 0.5,
             "shift_xy": rng.integers(-2, 3, (B, 2)).astype(np.int32),
             "aug_seed": rng.integers(0, 2**31 - 1, B).astype(np.uint32)}
        if mask:
            b["mask"] = np.stack([rng.permutation(16) < 8 for _ in range(B)])
        if label:
            b["label"] = rng.integers(0, 4, B).astype(np.int32)
        out.append(b)
    return out


def _stack(bufs):
    return {k: np.stack([b[k] for b in bufs]) for k in bufs[0]}


def _block(bufs, drop=("aug_seed",)):
    """(k, ...) torch block of host batches."""
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32 else v)
            for k, v in _stack(bufs).items() if k not in drop}


def _redraw(rng, tree):
    def one(path, leaf):
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            return jnp.asarray(1.0 + 0.5 * rng.random(leaf.shape), jnp.float32)
        base = 1.0 if "scale" in name else 0.0
        return jnp.asarray(base + 0.1 * rng.standard_normal(leaf.shape), jnp.float32)

    return jax.device_get(jax.tree_util.tree_map_with_path(one, tree))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# -- (a) the chain against the JAX package's chain=True ------------------------

_VIT = dict(img_size=(HW, HW), patch_size=(8, 8), in_chans=3, embed_dim=32, depth=2,
            num_heads=2)
_VAE = dict(num_tokens=16, codebook_dim=8, num_layers=2, num_resnet_blocks=0, hidden_dim=16)
_MAE = dict(img_size=HW, patch_size=8, in_chans=3, embed_dim=32, depth=2, num_heads=2,
            decoder_embed_dim=16, decoder_depth=1, decoder_num_heads=2)


def _pretrain_vs_jax(rng):
    kw = dict(_VIT, vocab_size=16, init_values=0.1, use_shared_rel_pos_bias=True,
              num_masked_tokens=8)
    fmodel = jax_create("pt_vit", kw)
    params = _redraw(rng, jax.jit(fmodel.init)(jax.random.key(0), jnp.zeros((1, HW, HW, 3)),
                                               jnp.zeros((1, 16), bool)))
    fvae = JaxDiscreteVAE(input_hw=(HW, HW), **_VAE)
    vparams = _redraw(rng, jax.jit(fvae.init)({"params": jax.random.key(1),
                                               "gumbel": jax.random.key(2)},
                                              jnp.zeros((1, HW, HW, 3)), 1.0))
    bufs = _events(rng, K, mask=True)
    tx = jax_optim.create_optimizer(params, as_schedule_fn(LR), wd_schedule=as_schedule_fn(WD),
                                    weight_decay=0.05, clip_grad=1.0)
    cstep = jax_pretrain_step(fmodel, fvae, tx, JaxPreprocConfig(**_PP), chain=True)
    jp, _, ms = cstep(params, tx.init(params), vparams, jax.tree.map(jnp.asarray, _stack(bufs)),
                      jax.random.key(9))
    tmodel = create_model("pt_vit", **kw)
    tmodel.load_state_dict(from_jax_params(params), strict=True)
    tvae = DiscreteVAE((HW, HW), **_VAE)
    tvae.load_state_dict(vae_from_jax_params(vparams), strict=True)
    chain = S.make_pretrain_train_step(tmodel, tvae, optim.create_optimizer(tmodel, 1e-3, 0.05),
                                       PreprocConfig(**_PP), LR, WD, 1.0, chain=True)
    got = chain(_block(bufs), 0)
    return got, ms, tmodel, from_jax_params(jax.device_get(jp))


def jax_create(name, kw):
    from mem_tpu.models.registry import create_model as jax_create_model

    return jax_create_model(name, dtype=jnp.float32, **kw)


def _mae_vs_jax(rng):
    fmodel = JaxMAE(**_MAE)
    params = _redraw(rng, jax.jit(fmodel.init)(
        {"params": jax.random.key(0), "mask": jax.random.key(1)}, jnp.zeros((1, HW, HW, 3))))
    bufs = _events(rng, K)
    tx = jax_optim.create_optimizer(params, as_schedule_fn(LR), wd_schedule=as_schedule_fn(WD),
                                    weight_decay=0.05, clip_grad=1.0)
    root = jax.random.key(7)
    cstep = jax_mae_step(fmodel, tx, JaxPreprocConfig(**_PP), chain=True)
    jp, _, ms = cstep(params, tx.init(params), jax.tree.map(jnp.asarray, _stack(bufs)), root)
    # each step's shuffle noise, as the JAX chain draws it (steps.py:224-233)
    noise = np.stack([np.asarray(jax.random.uniform(jax.random.split(k)[0], (B, 16)))
                      for k in jax.random.split(root, K)])
    tmodel = mae.MaskedAutoencoderViT(**_MAE)
    tmodel.load_state_dict(mae_from_jax_params(params), strict=True)
    chain = S.make_mae_train_step(tmodel, optim.create_optimizer(tmodel, 1e-3, 0.05),
                                  PreprocConfig(**_PP), LR, WD, 1.0, chain=True)
    got = chain({**_block(bufs), "noise": torch.from_numpy(noise)}, 0)
    return got, ms, tmodel, mae_from_jax_params(jax.device_get(jp))


def _finetune_vs_jax(rng, ema):
    kw = dict(_VIT, num_classes=4, patch_size=(4, 4), init_values=0.1,
              use_rel_pos_bias=True, use_mean_pooling=True, drop_path_rate=0.0)
    fmodel = jax_create("ft_vit", kw)
    params = _redraw(rng, jax.jit(fmodel.init)(jax.random.key(0), jnp.zeros((1, HW, HW, 3))))
    steps = [_events(rng, 2, label=True) for _ in range(K)]       # update_freq 2
    block = _stack([_stack(m) for m in steps])                    # (K, 2, B, ...)
    tx = jax_optim.create_optimizer(params, as_schedule_fn(LR), wd_schedule=as_schedule_fn(WD),
                                    weight_decay=0.05, layer_decay=0.9, num_layers=2,
                                    clip_grad=1.0)
    decay = 0.9 if ema else None
    cstep = jax_finetune_step(fmodel, tx, JaxPreprocConfig(**_PP), 4, update_freq=2,
                              ema_decay=decay, chain=True)
    jb = jax.tree.map(jnp.asarray, block)
    if ema:
        jp, _, jema, ms = cstep(params, tx.init(params), jax.tree.map(jnp.array, params), jb,
                                jax.random.key(3))
    else:
        jp, _, ms = cstep(params, tx.init(params), jb, jax.random.key(3))
    tmodel = create_model("ft_vit", **kw)
    tmodel.load_state_dict(from_jax_params(params), strict=True)
    tema = [p.detach().clone() for p in tmodel.parameters()] if ema else None
    opt = optim.create_optimizer(tmodel, 1e-3, 0.05, layer_decay=0.9, num_layers=2)
    chain = S.make_finetune_train_step(tmodel, opt, PreprocConfig(**_PP), 4, LR, WD,
                                       update_freq=2, ema=tema, ema_decay=decay, clip_grad=1.0,
                                       chain=True)
    got = chain({k: torch.from_numpy(v) for k, v in block.items() if k != "aug_seed"}, 0)
    extra = (tema, from_jax_params(jax.device_get(jema))) if ema else None
    return got, ms, tmodel, from_jax_params(jax.device_get(jp)), extra


def _vae_vs_jax(rng):
    fvae = JaxDiscreteVAE(input_hw=(HW, HW), kl_div_loss_weight=1e-3, **_VAE)
    variables = _redraw(rng, jax.jit(fvae.init)({"params": jax.random.key(0),
                                                 "gumbel": jax.random.key(1)},
                                                jnp.zeros((1, HW, HW, 3)), 1.0))
    bufs = _events(rng, K)
    sched = VaeAnnealState(1e-3, 0.5, starting_temp=1.0, anneal_rate=0.2, temp_min=0.5, every=1)
    lrs, temps = [], []
    for i in range(K):   # the anneal changes after every step, inside the chunk
        lrs.append(sched.lr)
        temps.append(sched.temp)
        sched.after_step(i)
    tx = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
    root = jax.random.key(5)
    cstep = jax_vae_step(fvae, tx, JaxPreprocConfig(**_PP), chain=True)
    jp, _, ms = cstep(variables, tx.init(variables), jax.tree.map(jnp.asarray, _stack(bufs)),
                      root, jnp.asarray(lrs, jnp.float32), jnp.asarray(temps, jnp.float32),
                      jnp.float32(1e-2))
    # each step's Gumbel noise, as the JAX chain draws it: the module's own
    # make_rng("gumbel") from the step's key (discrete_vae.py:290-295)
    shape = (B, HW // 4, HW // 4, _VAE["num_tokens"])
    noise = np.stack([np.asarray(jax.random.gumbel(
        fvae.apply(variables, method=lambda m: m.make_rng("gumbel"), rngs={"gumbel": k}),
        shape, dtype=jnp.float32)) for k in jax.random.split(root, K)])
    tvae = DiscreteVAE((HW, HW), kl_div_loss_weight=1e-3, **_VAE)
    tvae.load_state_dict(vae_from_jax_params(variables), strict=True)
    opt = torch.optim.Adam(tvae.parameters(), lr=1.0, betas=(0.9, 0.999), eps=1e-8)
    chain = S.make_vae_train_step(tvae, opt, PreprocConfig(**_PP), 1e-2, chain=True)
    got = chain({**_block(bufs), "gumbel_noise": torch.from_numpy(noise)}, 0,
                sched={"lr": lrs, "temp": temps})
    return got, ms, tvae, vae_from_jax_params(jax.device_get(jp))


def _seg_vs_jax(rng):
    fmodel, variables, tmodel = _segmentors(rng)
    bufs = [_seg_batch(rng, B=3, N=8000) for _ in range(K)]
    lr_fn = poly_lr_schedule(1e-3, K, warmup_iters=2)
    params, stats = variables["params"], variables["batch_stats"]
    wrapped = {"params": params}
    tx = jax_optim.scheduled_adamw(
        jax_train_seg.poly_lr_schedule(1e-3, K, warmup_iters=2), (lambda s: 0.05),
        jax_optim.build_lr_scale_tree(wrapped, 0.65, 2)["params"],
        jax_optim.build_wd_mask_tree(wrapped)["params"], b1=0.9, b2=0.999, eps=1e-8)
    cstep, _ = jax_train_seg.make_seg_steps(fmodel, tx, NUM_CLASSES, False, y_sorted=True,
                                            chain=True)
    jp, js, _, ms = cstep(params, stats, tx.init(params),
                          jax.tree.map(jnp.asarray, _stack(bufs)), jax.random.key(11))
    from mem_tpu_torch.cli.train_seg import SEG_BETAS

    opt = optim.create_optimizer(tmodel, 1e-3, 0.05, layer_decay=0.65, num_layers=2,
                                 betas=SEG_BETAS)
    chain, _ = S.make_seg_steps(tmodel, opt, lr_fn, 0.05, NUM_CLASSES, False, y_sorted=True,
                                chain=True)
    got = chain({k: v for k, v in _as_torch(_stack(bufs)).items() if k != "aug_seed"}, 0)
    return got, ms, tmodel, seg_from_jax_params(jax.device_get({"params": jp,
                                                                "batch_stats": js}))


# stage -> (the losses' and grad norms' relative tolerance, the params' check)
# as the step-at-a-time tests hold them (test_torch_train.py,
# test_torch_mae_train.py, test_torch_finetune.py, test_torch_vae_train.py,
# test_torch_seg_train.py)
_A = {"pretrain": _pretrain_vs_jax, "mae": _mae_vs_jax, "vae": _vae_vs_jax, "seg": _seg_vs_jax,
      "finetune_ema": lambda rng: _finetune_vs_jax(rng, True),
      "finetune_noema": lambda rng: _finetune_vs_jax(rng, False)}
_METRIC_RTOL = {"pretrain": 1e-4, "mae": 1e-4, "vae": 1e-4, "seg": 1e-4, "finetune_ema": 1e-5,
                "finetune_noema": 1e-5}


def _params_close(stage, model, want):
    """The final parameters, each stage's gate: pretrain (Adam's near-zero
    gradients move by +-lr a step either way: atol 4.2e-3, 99 % to 1e-5),
    seg (atol 1.7e-3, 99 % to 1e-4 of their scale, BatchNorm buffers 1e-4),
    the rest 1e-4 relative L2 per tensor."""
    if stage in ("pretrain", "seg"):
        n_all = n_close = 0
        for name, p in model.state_dict().items():
            w, d = want[name].numpy(), np.abs(p.detach().numpy() - want[name].numpy())
            if "running_" in name:
                assert d.max() <= 1e-4 * max(1.0, np.abs(w).max()), (name, float(d.max()))
                continue
            assert d.max() <= (4.2e-3 if stage == "pretrain" else 1.7e-3), (name, d.max())
            n_all += d.size
            near = 1e-5 if stage == "pretrain" else 1e-4 * np.maximum(1.0, np.abs(w))
            n_close += int((d <= near).sum())
        assert n_close / n_all >= 0.99, n_close / n_all
        return
    for name, p in model.named_parameters():
        assert _rel(p.detach().numpy(), want[name].numpy()) <= 1e-4, name


@pytest.mark.parametrize("stage", list(_A))
def test_chain_matches_jax_chain(stage):
    out = _A[stage](np.random.default_rng(0))
    got, want, model, want_params = out[:4]
    for key in ("loss", "grad_norm"):
        assert got[key].shape == (K,)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=_METRIC_RTOL[stage], err_msg=key)
    if stage == "pretrain":   # one flipped argmax in the ~16 masked tokens at most
        assert np.abs(got["mlm_acc"].numpy() - np.asarray(want["mlm_acc"])).max() <= 1 / 16 + 1e-6
    _params_close(stage, model, want_params)
    if stage == "finetune_ema":
        tema, jema = out[4]
        for (name, _), e in zip(model.named_parameters(), tema):
            assert _rel(e.numpy(), jema[name].numpy()) <= 1e-4, name


# -- (b) the chain against K single steps on the chunk's generator -------------

def _pretrain_pair(mae_mode=False):
    """(make() -> (model, build(chain) -> its K=1 step or its chain), the
    host batches with their draws): drop-path 0.1 (pretraining; the MAE
    draws its shuffle noise) and RandAugment's batch ops on."""
    pp = PreprocConfig(**dict(_PP, rand_aug=True, rand_aug_batch_ops=True))

    def make():
        if mae_mode:
            model = mae.MaskedAutoencoderViT(**_MAE)
        else:
            model = create_model("pt_vit", **_VIT, vocab_size=16, drop_path_rate=0.1,
                                 num_masked_tokens=8)
        model.init_weights(torch.Generator().manual_seed(0))
        opt = optim.create_optimizer(model, 1e-3, 0.05)
        if mae_mode:
            return model, lambda chain: S.make_mae_train_step(model, opt, pp, LR, WD, 1.0,
                                                              seed=4, chain=chain)
        return model, lambda chain: S.make_pretrain_train_step(
            model, _FixedTokens(), opt, pp, LR, WD, 1.0, seed=4, chain=chain)

    bufs = _events(np.random.default_rng(1), K, mask=not mae_mode)
    for b in bufs:
        b.update(draw_train_aug(b["aug_seed"], pp, HW, HW))
    return make, bufs


class _FixedTokens:
    """A tokenizer stand-in: the same codes for every image."""

    def get_codebook_indices(self, images):
        return (torch.arange(16)[None] % 16).expand(images.shape[0], 16)


def _step_batch(b):
    """A host batch as a K=1 step takes it: tensors, the batch ops numpy
    (the host branch)."""
    out = {k: v for k, v in _as_torch(b).items() if k != "aug_seed"}
    if "ra_batch_ops" in b:
        out["ra_batch_ops"] = b["ra_batch_ops"]
    return out


def _single_steps_on_chunk_generator(monkeypatch, seed, calls):
    """Run ``calls`` (single steps) with every step_generator handing out one
    generator seeded as the chunk's."""
    gen = torch.Generator().manual_seed(chunk_seed(seed, 0))
    monkeypatch.setattr(S, "step_generator", lambda s, it, device: gen)
    return [c() for c in calls]


def _assert_bit_equal(chain_m, single_ms, model_a, model_b):
    for key in chain_m:
        assert torch.equal(chain_m[key], torch.stack([m[key] for m in single_ms])), key
    for (name, a), b in zip(model_a.state_dict().items(), model_b.state_dict().values()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("stage", ["pretrain", "mae"])
def test_chain_equals_single_steps_pretrain(stage, monkeypatch):
    """The chain's block carries the batch ops as a tensor (chosen on the
    device), the single steps as numpy (the host branch)."""
    make, bufs = _pretrain_pair(mae_mode=stage == "mae")
    model_c, build_c = make()
    got = build_c(True)(_block(bufs), 0)
    assert got["loss"].shape == (K,)
    model_s, build_s = make()
    step = build_s(False)
    single = _single_steps_on_chunk_generator(
        monkeypatch, 4, [lambda i=i: step(_step_batch(bufs[i]), i) for i in range(K)])
    _assert_bit_equal(got, single, model_c, model_s)


def test_chain_equals_single_steps_finetune(monkeypatch):
    """update_freq 2 and the EMA; dropout and drop-path on."""
    pp = PreprocConfig(**_PP)
    rng = np.random.default_rng(2)
    steps = [_events(rng, 2, label=True) for _ in range(K)]

    def make():
        model = create_model("ft_vit", **dict(_VIT, num_classes=4), drop_rate=0.1,
                             drop_path_rate=0.1, use_mean_pooling=True)
        model.init_weights(torch.Generator().manual_seed(0))
        ema = [p.detach().clone() for p in model.parameters()]
        opt = optim.create_optimizer(model, 1e-3, 0.05, layer_decay=0.9, num_layers=2)
        return model, ema, lambda chain: S.make_finetune_train_step(
            model, opt, pp, 4, LR, WD, update_freq=2, ema=ema, ema_decay=0.9, clip_grad=1.0,
            seed=6, chain=chain)

    model_c, ema_c, build_c = make()
    block = {k: torch.from_numpy(v) for k, v in _stack([_stack(m) for m in steps]).items()
             if k != "aug_seed"}
    got = build_c(True)(block, 0)
    model_s, ema_s, build_s = make()
    step = build_s(False)
    single = _single_steps_on_chunk_generator(monkeypatch, 6, [
        lambda i=i: step([_step_batch(m) for m in steps[i]], i) for i in range(K)])
    _assert_bit_equal(got, single, model_c, model_s)
    assert all(torch.equal(a, b) for a, b in zip(ema_c, ema_s))


def test_chain_equals_single_steps_vae(monkeypatch):
    """The anneal changing inside the chunk, the Gumbel noise drawn."""
    pp = PreprocConfig(**_PP)
    bufs = _events(np.random.default_rng(3), K)
    lrs, temps = [1e-3, 5e-4, 2.5e-4], [1.0, 0.8, 0.6]

    def make():
        vae = DiscreteVAE((HW, HW), **_VAE)
        vae.init_weights(torch.Generator().manual_seed(0))
        opt = torch.optim.Adam(vae.parameters(), lr=1.0, betas=(0.9, 0.999), eps=1e-8)
        return vae, lambda chain: S.make_vae_train_step(vae, opt, pp, 1e-2, seed=8, chain=chain)

    vae_c, build_c = make()
    got = build_c(True)(_block(bufs), 0, sched={"lr": lrs, "temp": temps})
    vae_s, build_s = make()
    step = build_s(False)
    single = _single_steps_on_chunk_generator(monkeypatch, 8, [
        lambda i=i: step(_step_batch(bufs[i]), i, lrs[i], temps[i]) for i in range(K)])
    _assert_bit_equal(got, single, vae_c, vae_s)


def test_chain_equals_single_steps_seg(monkeypatch):
    """Dropout and drop-path on, RandAugment's batch ops chosen on the
    device in the chain and on the host in the single steps."""
    from mem_tpu_torch.cli.train_seg import SEG_BETAS
    from mem_tpu_torch.data.seg_pipeline import draw_seg_train_aug
    from mem_tpu_torch.models import segmentation as tseg

    rng = np.random.default_rng(4)
    bufs = [_seg_batch(rng, B=2, N=8000) for _ in range(K)]
    for b in bufs:
        b.update(draw_seg_train_aug(b["aug_seed"], True))
    lr_fn = poly_lr_schedule(1e-3, 10, warmup_iters=2)

    def make():
        model = tseg.EncoderDecoder(
            num_classes=NUM_CLASSES, backbone_cfg=dict(img_size=64, embed_dim=32, depth=2,
                                                       num_heads=2, out_indices=(0, 0, 0, 1),
                                                       drop_path_rate=0.1),
            head_channels=16, aux_channels=8, dropout_ratio=0.1, dtype=torch.float32)
        model.init_weights(torch.Generator().manual_seed(0))
        opt = optim.create_optimizer(model, 1e-3, 0.05, layer_decay=0.65, num_layers=2,
                                     betas=SEG_BETAS)
        return model, lambda chain: S.make_seg_steps(model, opt, lr_fn, 0.05, NUM_CLASSES, True,
                                                     True, y_sorted=True, seed=9,
                                                     chain=chain)[0]

    model_c, build_c = make()
    got = build_c(True)({k: v for k, v in _as_torch(_stack(bufs)).items() if k != "aug_seed"},
                        0)
    model_s, build_s = make()
    step = build_s(False)

    single = _single_steps_on_chunk_generator(
        monkeypatch, 9, [lambda i=i: step(_step_batch(bufs[i]), i) for i in range(K)])
    _assert_bit_equal(got, single, model_c, model_s)


# -- (c) the device-side batch op ------------------------------------------------

@pytest.mark.parametrize("op", range(ra.NUM_OPS), ids=ra.OP_NAMES)
def test_device_batch_op_equals_host_branch(op):
    """Each op as the batch op of a round (on a uint8 batch at the
    pipeline's sizes, with signed magnitudes), chosen on the device, against
    apply_op's host branch: bit-equal, also after a second round."""
    rng = np.random.default_rng(op)
    u8 = torch.from_numpy(rng.integers(0, 256, (3, 24, 40, 3)).astype(np.uint8))
    ops = torch.full((3, 2), op, dtype=torch.int32)
    ops[:, 1] = int(rng.integers(0, ra.NUM_OPS))
    bins = torch.from_numpy(rng.integers(0, 21, (3, 2)).astype(np.int32))
    signs = torch.from_numpy(rng.integers(0, 2, (3, 2)).astype(np.int32))
    host = ra.rand_augment_batch(u8, ops, bins, signs, ops[0].numpy())
    dev = ra.rand_augment_batch(u8, ops, bins, signs, ops[0].clone())
    assert torch.equal(host, dev)
    mag = ra.signed_magnitudes(ra.magnitude_table(24, 40), ops[:, 0], bins[:, 0], signs[:, 0])
    # whole pixel values and fractional ones (a round after a resample)
    frac = torch.from_numpy(rng.uniform(0, 255, (3, 24, 40, 3)).astype(np.float32))
    for img in (u8.float(), frac):
        want = ra.apply_op(img, op, mag)
        assert torch.equal(ra.select_op(img, torch.tensor(op), mag), want)
        if op in ra.PHOTOMETRIC_IDS:   # the seg pipeline's pool
            assert torch.equal(ra.select_op(img, torch.tensor(op), mag, ra.PHOTOMETRIC_IDS), want)


# -- (c') the graph form's optimizer arithmetic against the stock update ---------
#
# On the card the graph form drives the optimizer through optim.DeviceSchedule
# (the lr times each group's scale and the wd in 0-d f32 tensors, the decay
# applied by DeviceSchedule.write), the eager form and the step-at-a-time run
# through the stock update with host floats. Here both run on the CPU (no
# ``capturable``: torch.optim captures only on a device), over groups with
# layer-decay scales and without decay. The device path rounds lr * scale and
# 1 - lr * wd in f32 where the stock update works in f64: 1.2e-7 at most after
# six steps (an ulp of the largest parameters), so the gate is 1e-6; each
# planted fault moves a parameter by 9.1e-5 or more.

SCHEDULE_TOL = 1e-6
_SCHEDULE_OPTS = [("adamw", None), ("adamw", torch.bfloat16), ("adam", None), ("nadam", None),
                  ("rmsprop", None), ("adadelta", None)]
_SCHEDULE_IDS = ["adamw", "adamw_bf16_moments", "adam", "nadam", "rmsprop", "adadelta"]


class _LayeredNet(torch.nn.Module):
    """Names that give layer-decay groups (``blocks.N``, ``pos_embed``,
    ``head``) with and without decay (norms, biases, ``pos_embed``)."""

    def __init__(self):
        super().__init__()
        self.pos_embed = torch.nn.Parameter(0.02 * torch.randn(1, 4, 16))
        self.blocks = torch.nn.ModuleList(
            torch.nn.Sequential(torch.nn.LayerNorm(16), torch.nn.Linear(16, 16))
            for _ in range(2))
        self.head = torch.nn.Linear(16, 4)

    def forward(self, x):
        x = x + self.pos_embed
        for b in self.blocks:
            x = x + torch.tanh(b(x))
        return self.head(x)


def _schedule_run(name, moment_dtype, device_schedule, fault=None, steps=6):
    """Six steps of a _LayeredNet (lr and wd changing every step) through
    the stock update or, with ``device_schedule``, through DeviceSchedule
    with a planted ``fault``; returns the final parameters."""
    torch.manual_seed(0)
    net = _LayeredNet()
    opt = optim.create_optimizer(net, 1e-2, 0.1, opt=name, layer_decay=0.75, num_layers=2,
                                 moment_dtype=moment_dtype)
    assert {(g["lr_scale"] < 1, g["decays"]) for g in opt.param_groups} == {
        (True, True), (True, False), (False, True), (False, False)}
    if device_schedule:
        ds = optim.DeviceSchedule(opt, "cpu")
        if fault == "decay_on_a_no_decay_group":
            for i, g in enumerate(opt.param_groups):
                if not g["decays"]:
                    ds.wd[i] = torch.tensor(0.1)
        elif fault == "lr_scale_dropped":
            for g in opt.param_groups:
                g["lr_scale"] = 1.0
        elif fault == "decay_coupled_the_wrong_way":
            ds.kind = "coupled" if ds.kind == "decoupled" else "decoupled"
    xs = torch.randn(steps, 8, 4, 16, generator=torch.Generator().manual_seed(1))
    for i in range(steps):
        lr, wd = 1e-2 * (1 - 0.1 * i), 0.1 * (1 + 0.2 * i)
        loss = net(xs[i]).square().mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if device_schedule:   # the graph form's values: 0-d f32 tensors
            optim.set_schedule(opt, torch.tensor(lr, dtype=torch.float32),
                               torch.tensor(wd, dtype=torch.float32))
        else:
            optim.set_schedule(opt, lr, wd)
        opt.step()
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def _schedule_gap(name, moment_dtype, fault=None):
    stock = _schedule_run(name, moment_dtype, False)
    dev = _schedule_run(name, moment_dtype, True, fault)
    return max((stock[k] - dev[k]).abs().max().item() for k in stock)


@pytest.mark.parametrize("name,moment_dtype", _SCHEDULE_OPTS, ids=_SCHEDULE_IDS)
def test_device_schedule_equals_the_stock_update(name, moment_dtype):
    assert _schedule_gap(name, moment_dtype) <= SCHEDULE_TOL


@pytest.mark.parametrize("fault", ["decay_on_a_no_decay_group", "lr_scale_dropped",
                                   "decay_coupled_the_wrong_way"])
@pytest.mark.parametrize("name,moment_dtype", _SCHEDULE_OPTS, ids=_SCHEDULE_IDS)
def test_device_schedule_fault_fails_the_gate(name, moment_dtype, fault):
    assert _schedule_gap(name, moment_dtype, fault) > 50 * SCHEDULE_TOL


# -- (d) the CLIs' chunk boundaries and per-step schedules ------------------------

class _Recorded:
    """A chain that records each call's (first step, k)."""

    def __init__(self, chain, calls):
        self.chain, self.calls, self.describe = chain, calls, chain.describe
        self.host_keys, self.input_slots = chain.host_keys, chain.input_slots

    def __call__(self, block, it0, **kw):
        self.calls.append((it0, int(next(iter(block.values())).shape[0])))
        return self.chain(block, it0, **kw)


@pytest.fixture(scope="module")
def small_seg_dataset(tmp_path_factory):
    """4 train and 1 val (events .npy, label .png) pairs of 6,000 events."""
    from PIL import Image

    root = tmp_path_factory.mktemp("dsec")
    rng = np.random.default_rng(5)
    for split, n in (("train", 4), ("val", 1)):
        (root / "imgs" / split / "seq0").mkdir(parents=True)
        (root / "anns" / split / "seq0").mkdir(parents=True)
        for i in range(n):
            ev = np.zeros((6000, 4), np.float32)
            ev[:, 0] = rng.integers(0, 640, 6000)
            ev[:, 1] = rng.integers(0, 480, 6000)
            ev[:, 3] = rng.integers(0, 2, 6000)
            np.save(root / "imgs" / split / "seq0" / f"{i:06d}.npy", ev)
            lab = np.repeat(np.repeat(rng.integers(0, 3, (11, 16)), 40, 0), 40, 1).astype(np.uint8)
            Image.fromarray(lab).save(root / "anns" / split / "seq0" / f"{i:06d}.png")
    return str(root)


def test_train_seg_chunks_stop_at_the_eval_interval(small_seg_dataset, tmp_path, monkeypatch,
                                                    capsys):
    """K=3, an eval interval of 4 and 5 iterations: chunks of 3, 1 and 1,
    the evaluation after iteration 3 (and the final one), the history of
    the one-at-a-time run (iteration 0). The segmentor's heads are
    narrowed (16 / 8 channels): the test is of the loop."""
    from mem_tpu_torch.cli import train_seg as cli
    from mem_tpu_torch.models import segmentation as tseg

    def narrow(num_classes, size, embed_dim, depth, num_heads, dtype, device, **kw):
        return tseg.EncoderDecoder(
            num_classes=num_classes, backbone_cfg=dict(
                img_size=size, embed_dim=embed_dim, depth=depth, num_heads=num_heads,
                out_indices=tuple(max(0, depth - 4 + k) for k in range(4))),
            head_channels=16, aux_channels=8, dtype=dtype, device=device)

    monkeypatch.setattr(cli, "build_segmentor", narrow)
    calls, real = [], cli.make_seg_steps

    def recording(*a, **k):
        train_step, eval_step = real(*a, **k)
        return _Recorded(train_step, calls), eval_step

    monkeypatch.setattr(cli, "make_seg_steps", recording)
    hist = cli.main(["--data_root", small_seg_dataset, *_SIZE, "--batch_size", "2",
                     "--output_dir", str(tmp_path / "out"), "--eval_interval", "4",
                     "--save_interval", "1000", "--warmup_iters", "2", "--num_workers", "0",
                     "--max_iters", "5", "--steps_per_dispatch", "3"])
    text = capsys.readouterr().out
    assert calls == [(0, 3), (3, 1), (4, 1)]
    assert "chain: eager K=3 (device cpu)" in text
    assert [line.split(":")[0] for line in text.splitlines() if line.startswith("* iter ")] \
        == ["* iter 3"] and "final mIoU" in text
    assert [h[0] for h in hist] == [0] and np.isfinite(hist[0][1])


def test_train_vae_logs_each_step_s_anneal_lr(tmp_path, monkeypatch):
    """K=3 over 4 steps an epoch (chunks of 3 and 1) with the anneal moving
    after every step: the lr logged for every step is the anneal's walk,
    which the host made over each chunk's steps."""
    from mem_tpu_torch.cli import train_vae as V
    from mem_tpu_torch.train import schedules
    from test_torch_logging import _FakeWandb
    from test_torch_preemption import VAE_FLAGS, write_events

    import sys

    fake = _FakeWandb()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    monkeypatch.setattr(V, "SINK_EVERY", 1)
    real = schedules.VaeAnnealState

    class EveryStep(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **{**k, "every": 1})

    monkeypatch.setattr(V, "VaeAnnealState", EveryStep)
    root = write_events(str(tmp_path / "caltech"), np.random.default_rng(3), files=8)
    hist = V.main(["--data_path", root, "--output_dir", str(tmp_path / "vae"), "--device", "cpu",
                   *VAE_FLAGS, "--batch_size", "4", "--wandb", "1", "--epochs", "2",
                   "--steps_per_dispatch", "3", "--learning_rate", "3e-4",
                   "--lr_decay_rate", "0.9"])
    assert [h[0] for h in hist] == list(range(8))
    walk, want = EveryStep(3e-4, 0.9, 1.0, 1e-6, 0.5), []
    for epoch in range(2):
        for i in range(4):
            want.append(walk.lr)
            walk.after_step(i)
    got = [d["lr"] for d in fake.logs if "lr" in d]
    assert got == want and len(set(got)) == 8


# -- (e) exact resume at K=3 --------------------------------------------------------

@pytest.fixture(scope="module")
def chain_inputs(tmp_path_factory):
    """tests/test_torch_recycle.py's 12 training recordings with a seeded
    tokenizer and pt_vit checkpoint."""
    from mem_tpu_torch.models.discrete_vae import DiscreteVAE

    tmp = tmp_path_factory.mktemp("chain")
    rng = np.random.default_rng(0)
    root = tmp / "ncaltech101"
    for split, n in (("train", 12), ("val", 4)):
        for i in range(n):
            d = root / split / f"c{i % 2}"
            d.mkdir(parents=True, exist_ok=True)
            m = int(rng.integers(300, 2000))
            ev = np.zeros((m, 4))
            ev[:, 0] = rng.integers(0, 30, m)
            ev[:, 1] = rng.integers(0, 24, m)
            ev[:, 2] = np.sort(rng.integers(0, 10**5, m))
            ev[:, 3] = rng.choice([-1.0, 1.0], m)
            np.save(d / f"s{i}.npy", ev)
    vae = DiscreteVAE((32, 32), num_tokens=32, codebook_dim=8, num_layers=2,
                      num_resnet_blocks=1, hidden_dim=16)
    vae.init_weights(torch.Generator().manual_seed(2))
    hp = dict(input_H=32, input_W=32, num_tokens=32, emb_dim=8, num_layers=2,
              num_resnet_blocks=1, hidden_dim=16, channels=3, loss="mse")
    torch.save({"model": vae.state_dict(), "hparams": hp}, tmp / "vae.pth")
    pt = create_model("pt_vit", img_size=(32, 32), patch_size=(4, 4), embed_dim=32, depth=2,
                      num_heads=4, vocab_size=32, use_shared_rel_pos_bias=True)
    pt.init_weights(torch.Generator().manual_seed(1))
    torch.save({"model": pt.state_dict(), "epoch": 0}, tmp / "pt.pth")
    return str(root), str(tmp / "vae.pth"), str(tmp / "pt.pth")


def test_recycled_k3_run_is_bit_equal_to_a_straight_one(chain_inputs, tmp_path):
    """run_mem_pretraining at K=3 with batch 3 (4 steps an epoch: a chunk of
    3 and a tail of 1), 3 epochs, recycled at every epoch boundary against
    a straight run: every step's loss, the weights and the AdamW state
    bit-equal (the drop-path and the masks' streams go on across a resume)."""
    from mem_tpu_torch.tools.resume import state_diffs

    flags = exact_flags("run_mem_pretraining", chain_inputs) + [
        "--batch_size", "3", "--steps_per_dispatch", "3"]
    n0, straight, ck0 = run_arm("run_mem_pretraining", flags, str(tmp_path / "a"), False)
    n1, recycled, ck1 = run_arm("run_mem_pretraining", flags, str(tmp_path / "b"), True)
    assert (n0, n1) == (0, 2)
    assert [s for s, _ in straight] == list(range(12))
    assert recycled == straight
    assert state_diffs(ck0, ck1) == []


# -- (f) K=1 is the step-at-a-time run ----------------------------------------------

# each step's loss of the three CLIs at --steps_per_dispatch 1 on chain_inputs
# (3 epochs of 3 steps, f32, one torch thread), as the port gave them before
# chained dispatch (commit 1cd340f); bit-equal on the CPU they were taken on
# (AVX-512), to 1e-6 relative on another
K1_LOSSES = {
    "train_vae": [0.09369631856679916, 0.07815659046173096, 0.07684624940156937, 0.03336666524410248, 0.07054568082094193, 0.038551267236471176, 0.02905055321753025, 0.08084429055452347, 0.07172154635190964],
    "run_mem_pretraining": [3.495978355407715, 3.4835994243621826, 3.4400265216827393, 3.3962132930755615, 3.3456311225891113, 3.3191826343536377, 3.278939962387085, 3.253807544708252, 3.256706714630127],
    "run_class_finetuning": [0.6931473016738892, 0.6931444406509399, 0.702255368232727, 0.6973493695259094, 0.6958030462265015, 0.6934121251106262, 0.692263662815094, 0.6894928216934204, 0.6941264867782593],
}


@pytest.mark.parametrize("cli", list(K1_LOSSES))
def test_k1_reproduces_step_at_a_time_losses(cli, chain_inputs, tmp_path):
    flags = exact_flags(cli, chain_inputs) + ["--steps_per_dispatch", "1"]
    _, losses, _ = run_arm(cli, flags, str(tmp_path / cli), recycle=False)
    assert [s for s, _ in losses] == list(range(9))
    np.testing.assert_allclose([v for _, v in losses], K1_LOSSES[cli], rtol=1e-6, atol=0)
