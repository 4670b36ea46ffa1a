"""The port's optimizer switch held against the JAX package's
``create_optimizer``: every ``--opt`` name it accepts (the ``lookahead_``
and ``fused*`` forms included), with layer decay on and off and with the
global-norm clip active, over 7 f32 steps (Lookahead syncs once) of one
gradient sequence on a small ``ft_vit`` (width 128, so Adafactor factors
its matrices) carried across by ``from_jax_params``; each tensor's
displacement is gated at relative L2 <= 1e-5, and AdamP / SGDP's projection
decisions must agree on every tensor. Also ``--bf16_moments`` (<= 1e-3)
and the names that raise. The checkpoint round trips, on the same model and
gradients, are test_torch_optim_resume.py's."""
import functools
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mem_tpu.models.registry import create_model as jax_create_model
from mem_tpu.train import optim as jax_optim
from mem_tpu.train.schedules import as_schedule_fn
from mem_tpu_torch.models.registry import create_model
from mem_tpu_torch.train import optim
from mem_tpu_torch.train.schedules import cosine_scheduler
from mem_tpu_torch.utils.weights import from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MODEL = dict(num_classes=5, img_size=(32, 32), patch_size=(8, 8), in_chans=3,
              embed_dim=128, depth=1, num_heads=2, init_values=0.1, use_abs_pos_emb=True,
              use_rel_pos_bias=True)
STEPS = 7
CLIP = 50.0
WD = cosine_scheduler(0.05, 0.2, 1, STEPS)
# a base lr each optimizer moves the weights with by more than their
# rounding (Adadelta's steps are ~1e-3 of lr; SGD's the size of the grads)
BASE_LR = {"adadelta": 1.0, "sgd": 0.05, "nesterov": 0.05, "momentum": 0.05, "sgdp": 0.05,
           "novograd": 0.01, "nvnovograd": 0.01}
NAMES = list(optim.OPTIMIZERS)
# every base name with layer decay on and off; its lookahead_ form, the
# fused aliases and two mixed-case spellings with layer decay on
CASES = ([(n, ld) for n in NAMES for ld in (None, 0.75)]
         + [(f"lookahead_{n}", 0.75) for n in NAMES]
         + [(n, 0.75) for n in sorted(optim.FUSED_ALIASES)]
         + [("Lookahead_AdamP", 0.75), ("fusedLAMB", 0.75)])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the tensors are small, and the idle
    threads of a multi-threaded update only spin against the other test
    workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _lr(name):
    base = BASE_LR.get(optim.resolve_name(name)[0], 1e-2)
    return cosine_scheduler(base, base / 10, 1, STEPS, warmup_steps=2,
                            start_warmup_value=base / 4)


@functools.lru_cache(maxsize=None)
def _shapes():
    fmodel = jax_create_model("ft_vit", dtype=jnp.float32, **_MODEL)
    return jax.eval_shape(fmodel.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)))


def _variables(rng):
    # every leaf (the norms' scales too) at 0.02: each tensor's displacement
    # over 7 steps stays far above its own rounding
    return jax.tree.map(lambda p: (0.02 * rng.standard_normal(p.shape)).astype(np.float32),
                        _shapes())


def _grads(rng, params, t):
    """Step t's gradient on the flax layout, from the current weights: a
    third of the tensors get a gradient orthogonal to the weight within each
    output channel (AdamP's channel view fires), a third one orthogonal to
    the whole tensor only, a third one leaning on the weight (no
    projection): every decision far from its threshold."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    out = []
    for i, p in enumerate(leaves):
        p = np.asarray(p, np.float64)
        g = 0.1 * rng.standard_normal(p.shape)
        kind = (i + t) % 3
        if p.ndim >= 2 and kind == 0:
            axes = tuple(range(p.ndim - 1))
            g -= p * (p * g).sum(axes, keepdims=True) / (p * p).sum(axes, keepdims=True)
        elif p.ndim >= 2 and kind == 1:
            g -= p * (p * g).sum() / (p * p).sum()
        elif kind == 2:
            g += 3.0 * np.sign(p) * np.abs(g).mean()
        out.append(g.astype(np.float32))
    return jax.tree_util.tree_unflatten(tree, out)


def _port(variables, name, layer_decay, moment_dtype=None):
    tmodel = create_model("ft_vit", **_MODEL)
    tmodel.load_state_dict(from_jax_params(variables), strict=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        opt = optim.create_optimizer(tmodel, 1e-3, 0.05, opt=name, layer_decay=layer_decay,
                                     num_layers=1, momentum=0.9, moment_dtype=moment_dtype)
    return tmodel, opt


def _port_step(tmodel, opt, grads, t, lr):
    params = dict(tmodel.named_parameters())
    for k, g in from_jax_params({"params": grads["params"]}).items():
        params[k].grad = g.clone()
    optim.clip_grad_global_norm(params.values(), CLIP)
    optim.set_schedule(opt, float(lr[t]), float(WD[t]))
    opt.step()


@jax.jit
def _fired_tree(params, grads):
    factor = jnp.minimum(1.0, CLIP / (jax_optim.grad_global_norm(grads) + 1e-6))
    return jax.tree.map(lambda p, g: jax_optim._adamp_project(p, g * factor,
                                                              jnp.zeros_like(p))[1],
                        params, grads)


def _fired_jax(params, grads):
    """The JAX package's projection decision for every tensor (it depends on
    the weight and the clipped gradient only), in the port's names; one
    jitted call for the whole tree."""
    fired = jax.device_get(_fired_tree(params, grads))
    return {k: float(v.flatten()[0]) for k, v in from_jax_params(jax.tree.map(
        lambda p, f: np.full(np.shape(p), float(f), np.float32), params, fired)).items()}


def _run_both(rng, name, layer_decay, moment_dtype=None):
    """7 steps on both sides; returns (start, jax weights, port model,
    differing projection decisions, decisions compared)."""
    variables = _variables(rng)
    lr = _lr(name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tx = jax_optim.create_optimizer(
            variables, as_schedule_fn(lr), wd_schedule=as_schedule_fn(WD), weight_decay=0.05,
            layer_decay=layer_decay, num_layers=1, opt=name, momentum=0.9, clip_grad=CLIP,
            moment_dtype=None if moment_dtype is None else jnp.bfloat16)
    state = tx.init(variables)
    tmodel, opt = _port(variables, name, layer_decay, moment_dtype)
    start = from_jax_params(variables)
    params, differ, compared = variables, 0, 0
    projects = optim.resolve_name(name)[0] in ("adamp", "sgdp")
    for t in range(STEPS):
        grads = _grads(rng, params, t)
        want_fired = _fired_jax(params, grads) if projects else None
        updates, state = tx.update(grads, state, params)
        params = jax.device_get(jax.tree.map(lambda p, u: p + u, params, updates))
        _port_step(tmodel, opt, grads, t, lr)
        if projects:
            for k, p in tmodel.named_parameters():
                if p.ndim >= 2:
                    compared += 1
                    differ += int(float(opt.state[p]["fired"]) != want_fired[k])
    return start, from_jax_params(params), tmodel, differ, compared


def _gate(start, want, tmodel, bound):
    worst = {}
    for k, p in tmodel.named_parameters():
        d_want = want[k] - start[k]
        d_got = p.detach() - start[k]
        den = torch.linalg.vector_norm(d_want).item()
        num = torch.linalg.vector_norm(d_got - d_want).item()
        worst[k] = num / den if den > 0 else num
    bad = {k: v for k, v in worst.items() if v > bound}
    assert not bad, f"tensors past {bound}: {bad}"
    return max(worst.values())


@pytest.mark.parametrize("name,layer_decay", CASES,
                         ids=[f"{n}-{'ld_on' if ld else 'ld_off'}" for n, ld in CASES])
def test_optimizer_matches_jax(rng, name, layer_decay):
    start, want, tmodel, differ, compared = _run_both(rng, name, layer_decay)
    _gate(start, want, tmodel, 1e-5)
    if optim.resolve_name(name)[0] in ("adamp", "sgdp"):
        print(f"{name}: projection decisions differing: {differ} of {compared}")
        assert differ == 0 and compared > 0


def test_projection_fires_on_both_views(rng):
    """The gradient sequence exercises all three AdamP decisions, on
    tensors whose channel dim is torch's dim 0 (Linear, Conv) and on ones
    where it stays last (cls_token, pos_embed, the rel-pos tables)."""
    variables = _variables(rng)
    tmodel, opt = _port(variables, "adamp", None)
    axes = optim.channel_axes(tmodel)
    names = {p: k for k, p in tmodel.named_parameters()}
    by_name = {names[p]: a for p, a in axes.items()}
    assert by_name["blocks.0.attn.qkv.weight"] == 0 and by_name["patch_embed.proj.weight"] == 0
    assert by_name["pos_embed"] == 2 and by_name["cls_token"] == 2
    assert by_name["blocks.0.attn.relative_position_bias_table"] == 1
    grads = _grads(rng, variables, 0)
    kinds = set()
    for k, p in tmodel.named_parameters():
        if p.ndim >= 2:
            g = from_jax_params({"params": grads["params"]})[k]
            ch, whole = optim.adamp_fired(p.detach(), g, axes[p])
            kinds.add("ch" if ch else "all" if whole else "none")
    assert kinds == {"ch", "all", "none"}


@pytest.mark.parametrize("layer_decay", [None, 0.75], ids=["ld_off", "ld_on"])
def test_bf16_moments_match_jax(rng, layer_decay):
    start, want, tmodel, _, _ = _run_both(rng, "adamw", layer_decay, torch.bfloat16)
    _gate(start, want, tmodel, 1e-3)
    _, opt = _port(_variables(rng), "adamw", layer_decay, torch.bfloat16)
    assert isinstance(opt, optim.AdamWLowPrecision)


def test_bf16_moments_round_once_on_store(rng):
    """The stored moments are the f32 blends rounded once to bf16, and the
    step is taken from the unrounded blend."""
    w = torch.nn.Linear(8, 8, bias=False)
    opt = optim.AdamWLowPrecision([{"params": [w.weight], "lr_scale": 1.0, "decays": True,
                                    "weight_decay": 0.0}], lr=0.1)
    g = torch.randn(8, 8, generator=torch.Generator().manual_seed(0))
    w0 = w.weight.detach().clone()
    w.weight.grad = g.clone()
    opt.step()
    st = opt.state[w.weight]
    assert st["exp_avg"].dtype == torch.bfloat16 and w.weight.dtype == torch.float32
    assert torch.equal(st["exp_avg"], (0.1 * g).to(torch.bfloat16))
    assert torch.equal(st["exp_avg_sq"], ((1 - 0.95) * g * g).to(torch.bfloat16))
    mhat, vhat = 0.1 * g / 0.1, (1 - 0.95) * g * g / (1 - 0.95)
    torch.testing.assert_close(w.weight.detach(), w0 - 0.1 * mhat / (vhat.sqrt() + 1e-8),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name,match", [("adahessian", "Hessian"),
                                        ("lookahead_adahessian", "Hessian"),
                                        ("adagrad", "unsupported"), ("sgdw", "unsupported")])
def test_names_that_raise(rng, name, match):
    tmodel = create_model("ft_vit", **dict(_MODEL, embed_dim=32, depth=1))
    with pytest.raises(ValueError, match=match):
        optim.create_optimizer(tmodel, 1e-3, 0.05, opt=name)
    with pytest.raises(ValueError, match=match):
        jax_optim.create_optimizer({"w": jnp.zeros((2, 2))}, lambda s: 1e-3, opt=name)


@pytest.mark.parametrize("name", ["novograd", "lookahead_nvnovograd", "fusednovograd"])
def test_novograd_warns_under_a_wd_schedule(name):
    tmodel = create_model("ft_vit", **dict(_MODEL, embed_dim=32, depth=1))
    with pytest.warns(UserWarning, match="CONSTANT --weight_decay"):
        optim.create_optimizer(tmodel, 1e-3, 0.05, opt=name)


def test_freeze_backbone_stays_adamw():
    tmodel = create_model("ft_vit", **dict(_MODEL, embed_dim=32, depth=1))
    for name in ("sgd", "lookahead_lamb", "adamp"):
        opt = optim.create_optimizer(tmodel, 1e-3, 0.05, opt=name, freeze_backbone=True)
        assert type(opt) is torch.optim.AdamW


def test_state_bytes_counts_bf16_moments_at_half():
    tmodel = create_model("ft_vit", **dict(_MODEL, embed_dim=32, depth=1))
    n = sum(p.numel() for p in tmodel.parameters())
    sizes = {}
    for dt in (None, torch.bfloat16):
        opt = optim.create_optimizer(tmodel, 1e-3, 0.05, moment_dtype=dt)
        for p in tmodel.parameters():
            p.grad = torch.zeros_like(p)
        opt.step()
        sizes[dt] = optim.state_bytes(opt)
    assert sizes[None] - 4 * len(list(tmodel.parameters())) == 8 * n
    assert sizes[torch.bfloat16] - 4 * len(list(tmodel.parameters())) == 4 * n


def test_new_modules_import_no_jax():
    """The modules this slice adds (and the optimizer) import nothing of
    jax, flax, optax, orbax or mem_tpu."""
    mods = ["mem_tpu_torch.train.optim", "mem_tpu_torch.events", "mem_tpu_torch.events.slicer",
            "mem_tpu_torch.cli.process_dataset", "mem_tpu_torch.cli.make_subsets",
            "mem_tpu_torch.utils.timm_init", "mem_tpu_torch.utils.weights",
            "mem_tpu_torch.native"]
    code = ("import sys, importlib; "
            f"[importlib.import_module(m) for m in {mods!r}]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'orbax', 'mem_tpu', 'h5py')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=dict(os.environ, PYTHONPATH=REPO))


def test_norm_is_accurate_at_full_width():
    """The clip's and Lamb's / NovoGrad's norms on a tensor of fc1's size
    (768 x 3072): within 1e-6 of the f64 norm (torch's CPU vector_norm of
    an f32 tensor reads ~4e-5 off there)."""
    x = 0.02 * torch.randn(768 * 3072, generator=torch.Generator().manual_seed(0))
    want = torch.linalg.vector_norm(x.double()).item()
    assert abs(optim.norm(x).item() - want) <= 1e-6 * want
    p = torch.nn.Parameter(x.view(768, 3072))
    p.grad = x.view(768, 3072).clone()
    assert abs(optim.clip_grad_global_norm([p], None).item() - want) <= 1e-6 * want
