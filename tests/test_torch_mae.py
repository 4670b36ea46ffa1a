"""The port's MAE (models/mae.py) and MAE-finetune classifier
(models/mae_classifier.py) held against the flax MaskedAutoencoderViT and
MAEVisionTransformer with the same weights and the same shuffle noise:
the sin-cos table, patchify, the mask, the weight transfer (exact); the
forward and every gradient under the loss options, the einsum path, the
classifier's two readouts and bf16 (within the stated tolerances); the
drop-path schedule, the init distributions, the generator's noise, the
block's K2 / K3 route; and surgery_for_mae_finetune against the
reference's. The flax side runs attention through the Pallas flat kernels
in interpret mode (attention.ENABLED), as it routes on an accelerator."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mem_tpu.models.mae as jax_mae
import mem_tpu.ops.attention as jax_attention
from mem_tpu.models.mae_classifier import MAEVisionTransformer as JaxMAEClassifier
from mem_tpu.utils.surgery import surgery_for_mae_finetune as jax_surgery
from mem_tpu.utils.torch_import import (export_mae_classifier_params, export_mae_params,
                                        import_mae_state_dict)
from mem_tpu_torch.models import mae
from mem_tpu_torch.models.mae_classifier import MAEVisionTransformer
from mem_tpu_torch.models.registry import create_model
from mem_tpu_torch.utils.surgery import surgery_for_mae_finetune
from mem_tpu_torch.utils.weights import (mae_classifier_from_jax_params, mae_from_jax_params,
                                         normalize_mae_state_dict)

_MAE = dict(img_size=32, patch_size=8, in_chans=3, embed_dim=32, depth=2, num_heads=2,
            decoder_embed_dim=16, decoder_depth=1, decoder_num_heads=2)
_CLS = dict(img_size=(32, 32), patch_size=8, in_chans=3, num_classes=5, embed_dim=32,
            depth=2, num_heads=2)
B, L = 3, 16


def _redraw(rng, tree):
    def one(path, leaf):
        base = 1.0 if "scale" in jax.tree_util.keystr(path) else 0.0
        return jnp.asarray(base + 0.1 * rng.standard_normal(leaf.shape), jnp.float32)

    return jax.device_get(jax.tree_util.tree_map_with_path(one, tree))


def _mae_pair(rng, dtype="f32", **over):
    kw = dict(_MAE, **over)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    fmodel = jax_mae.MaskedAutoencoderViT(dtype=jdt, **kw)
    variables = _redraw(rng, jax.jit(fmodel.init)(
        {"params": jax.random.key(0), "mask": jax.random.key(1)}, jnp.zeros((1, 32, 32, 3))))
    tmodel = mae.MaskedAutoencoderViT(dtype=tdt, **kw)
    tmodel.load_state_dict(mae_from_jax_params(variables), strict=True)
    return fmodel, variables, tmodel


def _cls_pair(rng, dtype="f32", **over):
    kw = dict(_CLS, **over)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    fmodel = JaxMAEClassifier(dtype=jdt, **kw)
    variables = _redraw(rng, jax.jit(fmodel.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 3))))
    tmodel = MAEVisionTransformer(dtype=tdt, **kw)
    tmodel.load_state_dict(mae_classifier_from_jax_params(variables), strict=True)
    return fmodel, variables, tmodel


def _noise(key):
    return np.array(jax.random.uniform(key, (B, L)))


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


# -- exact -------------------------------------------------------------------

@pytest.mark.parametrize("dim,grid,cls", [(32, 4, True), (768, 14, True), (512, 14, False),
                                          (16, 1, True)])
def test_sincos_pos_embed_is_the_reference_s(dim, grid, cls):
    np.testing.assert_array_equal(mae.get_2d_sincos_pos_embed(dim, grid, cls),
                                  jax_mae.get_2d_sincos_pos_embed(dim, grid, cls))


@pytest.mark.parametrize("img_size", [(32, 32), (24, 40)])
def test_classifier_pos_embed_init_is_the_reference_s(img_size):
    """The sin-cos init of the learned table, the row-major crop of the
    square table on a non-square grid (mae_classifier.py:71-83)."""
    fmodel = JaxMAEClassifier(**dict(_CLS, img_size=img_size))
    want = jax.jit(fmodel.init)(jax.random.key(0), jnp.zeros((1,) + img_size + (3,)))
    tmodel = MAEVisionTransformer(**dict(_CLS, img_size=img_size))
    tmodel.init_weights(torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(tmodel.pos_embed.detach().numpy(),
                                  np.asarray(want["params"]["pos_embed"]))


def test_patchify_and_unpatchify_are_the_reference_s(rng):
    fmodel = jax_mae.MaskedAutoencoderViT(**_MAE)
    tmodel = mae.MaskedAutoencoderViT(**_MAE)
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    patches = tmodel.patchify(torch.from_numpy(x))
    np.testing.assert_array_equal(patches.numpy(), np.asarray(fmodel.patchify(jnp.asarray(x))))
    p = rng.random((2, 16, 192)).astype(np.float32)
    np.testing.assert_array_equal(tmodel.unpatchify(torch.from_numpy(p)).numpy(),
                                  np.asarray(fmodel.unpatchify(jnp.asarray(p))))
    np.testing.assert_array_equal(tmodel.unpatchify(patches).numpy(), x)


def test_mask_and_ids_restore_from_the_same_noise(rng):
    """argsort of the noise, stable on both sides (ties included): the kept
    tokens, ids_restore and the mask equal jnp's."""
    tmodel = mae.MaskedAutoencoderViT(**_MAE)
    noise = _noise(jax.random.key(3))
    noise[0, :6] = noise[0, 6]                     # ties
    x = torch.arange(B * L * 2, dtype=torch.float32).reshape(B, L, 2)
    kept, mask, restore = tmodel.random_masking(x, torch.from_numpy(noise))
    shuffle = jnp.argsort(jnp.asarray(noise), axis=1)
    want_restore = np.asarray(jnp.argsort(shuffle, axis=1))
    np.testing.assert_array_equal(restore.numpy(), want_restore)
    np.testing.assert_array_equal(kept.numpy(), np.take_along_axis(
        x.numpy(), np.asarray(shuffle)[:, :8, None], axis=1))
    want_mask = np.take_along_axis(np.concatenate([np.zeros((B, 8)), np.ones((B, 8))], 1),
                                   want_restore, axis=1)
    np.testing.assert_array_equal(mask.numpy(), want_mask)


def test_weights_equal_the_reference_export(rng):
    _, variables, tmodel = _mae_pair(rng)
    want, got = export_mae_params(variables), mae_from_jax_params(variables)
    assert set(got) == set(want) == set(tmodel.state_dict())
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    for pool in (True, False):
        _, variables, tmodel = _cls_pair(rng, global_pool=pool)
        want, got = export_mae_classifier_params(variables), mae_classifier_from_jax_params(
            variables)
        assert set(got) == set(want) == set(tmodel.state_dict())
        assert ("fc_norm.weight" in got) == pool and ("norm.weight" in got) != pool
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


# -- f32 against flax --------------------------------------------------------

def _forward_and_grads(rng, monkeypatch, flat=True, **over):
    monkeypatch.setattr(jax_attention, "ENABLED", True)
    monkeypatch.setattr(jax_mae, "FLAT_ATTN", flat)
    monkeypatch.setattr(mae, "FLAT_ATTN", flat)
    fmodel, variables, tmodel = _mae_pair(rng, **over)
    x = rng.random((B, 32, 32, 3)).astype(np.float32)
    key = jax.random.key(5)

    def jloss(v):
        loss, recon, mask = fmodel.apply(v, jnp.asarray(x), rng=key)
        return loss, (recon, mask)

    (jl, (jrecon, jmask)), jgrads = jax.value_and_grad(jloss, has_aux=True)(variables)
    tmodel.train()
    loss, recon, mask = tmodel(torch.from_numpy(x), noise=torch.from_numpy(_noise(key)))
    loss.backward()
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(recon.detach().numpy(), np.asarray(jrecon), rtol=0, atol=1e-5)
    want = mae_from_jax_params(jax.device_get(jgrads))
    for name, p in tmodel.named_parameters():
        assert _rel(p.grad.numpy(), want[name].numpy()) < 1e-4, name


@pytest.mark.parametrize("norm_pix,only_masked", [(False, False), (True, False), (False, True),
                                                  (True, True)])
def test_forward_and_gradients_match_flax(rng, monkeypatch, norm_pix, only_masked):
    """f32 both sides, one noise array: mask exactly, loss 1e-5 relative,
    reconstruction 1e-5 absolute, every parameter's gradient 1e-4 relative
    L2, under the 4 combinations of the loss options (the population
    variance of norm_pix_loss; the sum without a division by B)."""
    _forward_and_grads(rng, monkeypatch, norm_pix_loss=norm_pix, loss_only_masked=only_masked)


def test_einsum_path_matches_flax(rng, monkeypatch):
    """FLAT_ATTN = False on both sides (mae.py:98-102), the same bounds."""
    _forward_and_grads(rng, monkeypatch, flat=False, norm_pix_loss=True)


@pytest.mark.parametrize("global_pool", [True, False])
def test_classifier_matches_flax(rng, monkeypatch, global_pool):
    """f32 logits to 1e-5 and every gradient of their sum to 1e-4 relative
    L2, with the global-pool readout and with the cls token."""
    monkeypatch.setattr(jax_attention, "ENABLED", True)
    fmodel, variables, tmodel = _cls_pair(rng, global_pool=global_pool)
    x = rng.random((B, 32, 32, 3)).astype(np.float32)
    w = rng.standard_normal((B, 5)).astype(np.float32)
    jl, jgrads = jax.value_and_grad(
        lambda v: (fmodel.apply(v, jnp.asarray(x)) * w).sum())(variables)
    logits = tmodel(torch.from_numpy(x))
    (logits * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(fmodel.apply(variables, jnp.asarray(x))),
                               rtol=0, atol=1e-5)
    want = mae_classifier_from_jax_params(jax.device_get(jgrads))
    for name, p in tmodel.named_parameters():
        assert _rel(p.grad.numpy(), want[name].numpy()) < 1e-4, name


def test_bf16_forward_matches_flax(rng, monkeypatch):
    """bf16 compute, f32 params: test_torch_vit's bf16 bounds (2e-2 max abs,
    1e-2 relative L2) on the reconstruction and the classifier's logits, the
    loss to 1e-2 relative, the mask exactly."""
    monkeypatch.setattr(jax_attention, "ENABLED", True)
    fmodel, variables, tmodel = _mae_pair(rng, "bf16")
    x = rng.random((B, 32, 32, 3)).astype(np.float32)
    key = jax.random.key(7)
    jl, jrecon, jmask = fmodel.apply(variables, jnp.asarray(x), rng=key)
    with torch.no_grad():
        loss, recon, mask = tmodel(torch.from_numpy(x), noise=torch.from_numpy(_noise(key)))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert recon.dtype == torch.float32
    np.testing.assert_allclose(recon.numpy(), np.asarray(jrecon), rtol=0, atol=2e-2)
    assert _rel(recon.numpy(), np.asarray(jrecon)) < 1e-2
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-2)
    fmodel, variables, tmodel = _cls_pair(rng, "bf16")
    want = np.asarray(fmodel.apply(variables, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got = tmodel.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    assert _rel(got, want) < 1e-2


# -- schedules, init, noise ----------------------------------------------------

def test_drop_path_linspace_and_its_generator(rng):
    """The classifier's blocks take rate * i / max(depth - 1, 1)
    (mae_classifier.py:90-96); in training mode the rate draws from the
    generator passed to forward (the same seed, the same logits), and the
    MAE's blocks have none (mae.py:188, :202)."""
    tmodel = MAEVisionTransformer(**dict(_CLS, depth=4, drop_path_rate=0.3))
    assert [b.drop_path_rate for b in tmodel.blocks] == [0.3 * i / 3 for i in range(4)]
    assert all(b.drop_path_rate == 0 for b in mae.MaskedAutoencoderViT(**_MAE).blocks)
    tmodel.init_weights(torch.Generator().manual_seed(0))
    tmodel.train()
    x = torch.from_numpy(rng.random((8, 32, 32, 3)).astype(np.float32))
    a, b = (tmodel(x, torch.Generator().manual_seed(s)) for s in (1, 1))
    assert torch.equal(a, b)
    assert not torch.equal(a, tmodel(x, torch.Generator().manual_seed(2)))
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        tmodel(x)


def test_init_distributions_match_flax():
    """Weights cannot match bit for bit; their laws must. Per parameter:
    xavier-uniform kernels inside +-sqrt(6 / (fan_in + fan_out)) with the
    uniform's std to 10 % (the flax init's std to 10 % too), zero biases,
    unit LayerNorms, normal(0.02) tokens, the head trunc_normal(2e-5) inside
    +-4e-5."""
    kw = dict(_MAE, embed_dim=64, decoder_embed_dim=64)
    fm = jax_mae.MaskedAutoencoderViT(**kw)
    fv = export_mae_params(jax.jit(fm.init)({"params": jax.random.key(0),
                                              "mask": jax.random.key(1)},
                                             jnp.zeros((1, 32, 32, 3))))
    tm = mae.MaskedAutoencoderViT(**kw)
    tm.init_weights(torch.Generator().manual_seed(0))
    for name, p in tm.state_dict().items():
        t, f = p.numpy(), fv[name]
        if name.endswith("bias"):
            assert not t.any() and not f.any(), name
        elif "norm" in name:
            assert (t == 1).all() and (f == 1).all(), name
        elif name in ("cls_token", "mask_token"):
            assert t.std() < 0.04 and f.std() < 0.04, name
        else:
            fan_in = int(np.prod(t.shape[1:]))
            fan_out = t.shape[0] * int(np.prod(t.shape[2:]))
            lim = np.sqrt(6.0 / (fan_in + fan_out))
            assert np.abs(t).max() <= lim and np.abs(f).max() <= lim, name
            for s in (t.std(), f.std()):
                assert abs(s / (lim / np.sqrt(3)) - 1) < 0.1, (name, s)
    tc = MAEVisionTransformer(**dict(_CLS, num_classes=200))
    tc.init_weights(torch.Generator().manual_seed(0))
    head = tc.head.weight.detach().numpy()
    assert np.abs(head).max() <= 4e-5 and abs(head.std() / (0.88 * 2e-5) - 1) < 0.1


def test_noise_is_drawn_from_the_generator(rng):
    """Without ``noise`` the forward draws torch.rand((B, L)) from the
    generator: the same seed gives the same mask as that noise passed in;
    none raises."""
    tmodel = mae.MaskedAutoencoderViT(**_MAE)
    tmodel.init_weights(torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.random((B, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        drawn = tmodel(x, generator=torch.Generator().manual_seed(4))
        passed = tmodel(x, noise=torch.rand((B, L), generator=torch.Generator().manual_seed(4)))
        other = tmodel(x, generator=torch.Generator().manual_seed(5))
    for a, b in zip(drawn, passed):
        assert torch.equal(a, b)
    assert not torch.equal(drawn[2], other[2]) and drawn[2].sum() == B * 8
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        tmodel(x)


# -- routing -------------------------------------------------------------------

@pytest.mark.parametrize("N,kernel", [(256, "flat"), (257, "long")])
def test_block_routes_by_attention_route_and_matches_flax(rng, monkeypatch, N, kernel):
    """The block sends N <= FLAT_MAX_N (256) tokens to fused_attention_flat
    (K2) and longer ones to fused_attention_flat_long (K3), as
    attention_route says; its output equals the flax block's (whichever
    Pallas kernel that picks: both compute one function) to 1e-5."""
    monkeypatch.setattr(jax_attention, "ENABLED", True)
    calls = []
    for name in ("fused_attention_flat", "fused_attention_flat_long"):
        real = getattr(mae, name)
        monkeypatch.setattr(mae, name, lambda *a, _n=name, _f=real: calls.append(_n) or _f(*a))
    fblock = jax_mae._TimmBlock(16, 2)
    x = rng.standard_normal((1, N, 16)).astype(np.float32)
    variables = _redraw(rng, jax.jit(fblock.init)(jax.random.key(0), jnp.asarray(x)))
    want = np.asarray(fblock.apply(variables, jnp.asarray(x)))
    tblock = mae.TimmBlock(16, 2)
    p = variables["params"]
    sd = {f"{n}.{w}": torch.from_numpy(np.array(p[n][f])) for n in ("norm1", "norm2")
          for w, f in (("weight", "scale"), ("bias", "bias"))}
    for n in ("qkv", "proj", "fc1", "fc2"):
        sd[f"{n}.weight"] = torch.from_numpy(np.array(p[n]["kernel"]).T.copy())
        sd[f"{n}.bias"] = torch.from_numpy(np.array(p[n]["bias"]))
    tblock.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tblock(torch.from_numpy(x)).numpy()
    assert calls == ["fused_attention_flat" + ("" if kernel == "flat" else "_long")]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# -- surgery -----------------------------------------------------------------

def _surgery_inputs(rng, src_img=32, dst_img=(32, 32), src_classes=None):
    """An MAE pretraining tree, its port state_dict, and a classifier
    template tree (flax) and state_dict (port) at ``dst_img``."""
    fm = jax_mae.MaskedAutoencoderViT(**dict(_MAE, img_size=src_img))
    src = _redraw(rng, jax.jit(fm.init)({"params": jax.random.key(0), "mask": jax.random.key(1)},
                                        jnp.zeros((1, src_img, src_img, 3))))
    kw = dict(_CLS, img_size=dst_img)
    fc = JaxMAEClassifier(**kw)
    tmpl = jax.device_get(jax.jit(fc.init)(jax.random.key(2), jnp.zeros((1,) + dst_img + (3,))))
    tc = MAEVisionTransformer(**kw)
    tc.load_state_dict(mae_classifier_from_jax_params(tmpl), strict=True)
    tsd = {k: v.numpy() for k, v in tc.state_dict().items()}
    return src, {k: v.numpy() for k, v in mae_from_jax_params(src).items()}, tmpl, tsd


def _assert_same(got, want_tree):
    want = export_mae_classifier_params(want_tree)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_surgery_same_grid_matches_the_reference(rng):
    src, sd, tmpl, tsd = _surgery_inputs(rng)
    got = surgery_for_mae_finetune(sd, tsd, grid=(4, 4))
    _assert_same(got, jax_surgery(src, tmpl, grid=(4, 4)))
    np.testing.assert_array_equal(got["blocks.1.qkv.weight"], sd["blocks.1.qkv.weight"])
    np.testing.assert_array_equal(got["head.weight"], tsd["head.weight"])


def test_surgery_cross_grid_with_src_grid_matches_the_reference(rng):
    """A 32^2 pretraining (4x4 grid) into a 24x40 classifier: the source
    grid's sin-cos table synthesised and bicubic-interpolated to (3, 5)."""
    src, sd, tmpl, tsd = _surgery_inputs(rng, dst_img=(24, 40))
    got = surgery_for_mae_finetune(sd, tsd, grid=(3, 5), src_grid=4)
    _assert_same(got, jax_surgery(src, tmpl, grid=(3, 5), src_grid=4))
    assert not np.array_equal(got["pos_embed"], tsd["pos_embed"])


def test_surgery_timm_named_pth_matches_import_mae_state_dict(rng):
    """A timm-named MAE state_dict (``patch_embed.proj.*``, ``.attn.``,
    ``.mlp.``, its saved ``pos_embed`` and ``decoder_pos_embed``) through
    normalize_mae_state_dict, against import_mae_state_dict + the
    reference's surgery, with the head of another class count dropped."""
    src, sd, _, _ = _surgery_inputs(rng)
    timm = {}
    for k, v in sd.items():
        k = k.replace("patch_embed.", "patch_embed.proj.")
        for lin, mod in (("qkv", "attn"), ("proj", "attn"), ("fc1", "mlp"), ("fc2", "mlp")):
            if f".{lin}." in k and k.startswith(("blocks.", "decoder_blocks.")):
                k = k.replace(f".{lin}.", f".{mod}.{lin}.")
        timm[k] = v
    timm["pos_embed"] = mae.get_2d_sincos_pos_embed(32, 4)[None] + 0.01
    timm["decoder_pos_embed"] = mae.get_2d_sincos_pos_embed(16, 4)[None]
    timm["head.weight"] = np.ones((7, 32), np.float32)
    assert "blocks.0.attn.qkv.weight" in timm and "patch_embed.proj.weight" in timm
    _, _, tmpl, tsd = _surgery_inputs(rng)
    norm = normalize_mae_state_dict(timm)
    assert set(norm) == set(sd) | {"pos_embed", "head.weight"}
    got = surgery_for_mae_finetune(norm, tsd, grid=(4, 4))
    _assert_same(got, jax_surgery(import_mae_state_dict(timm), tmpl, grid=(4, 4)))
    np.testing.assert_array_equal(got["pos_embed"], timm["pos_embed"])
    np.testing.assert_array_equal(got["head.weight"], tsd["head.weight"])


def test_surgery_strict_assert(rng):
    """Missing keys beyond {head, fc_norm} raise, as the reference's assert."""
    src, sd, tmpl, tsd = _surgery_inputs(rng)
    del sd["blocks.1.fc2.weight"]
    del src["params"]["blocks_1"]["fc2"]["kernel"]
    with pytest.raises(AssertionError, match="blocks.1.fc2.weight"):
        surgery_for_mae_finetune(sd, tsd, grid=(4, 4))
    with pytest.raises(AssertionError, match="blocks_1/fc2/kernel"):
        jax_surgery(src, tmpl, grid=(4, 4))


def test_registry_builds_the_reference_s_geometry():
    m = create_model("vit_base_patch16", num_classes=3, img_size=(32, 32), patch_size=8,
                     embed_dim=32, depth=2, num_heads=2)
    assert isinstance(m, MAEVisionTransformer) and m.global_pool and len(m.blocks) == 2
    assert create_model("vit_base_patch16", num_classes=3).grid == (14, 14)
    with torch.device("meta"):
        big = create_model("mae_vit_base_patch16_dec512d8b")
    assert (len(big.blocks), len(big.decoder_blocks), big.blocks[0].num_heads,
            big.decoder_blocks[0].num_heads, big.decoder_embed.out_features) == (12, 8, 12, 16,
                                                                                   512)
