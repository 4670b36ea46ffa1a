"""The port's pt_vit (models/pretrain.py) held against the flax
VisionTransformerForMaskedImageModeling with the same weights: weight
transfer, the gathered forward (logits, idx) and the gradient of the
gathered masked cross-entropy; both masked-CE forms; drop-path and its
depth schedule. The flax side runs attention through the Pallas K2f/K2b
kernels in interpret mode (attention.ENABLED), as it routes on an
accelerator."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mem_tpu.ops.attention as jax_attention
from mem_tpu.models import pretrain as jax_pretrain
from mem_tpu.models.registry import create_model as jax_create_model
from mem_tpu.utils.torch_import import export_vit_params
from mem_tpu_torch.models import pretrain
from mem_tpu_torch.models.registry import create_model
from mem_tpu_torch.models.vit import VitEncoder, drop_path, drop_path_rates
from mem_tpu_torch.utils.weights import from_jax_params

_KW = dict(img_size=(32, 32), patch_size=(4, 4), in_chans=3, vocab_size=16, embed_dim=32,
           depth=2, num_heads=4, init_values=0.1, num_masked_tokens=20)


def _mask(rng, B, N=64, M=20):
    """Up to M masked positions per sample (the block generator's bound)."""
    mask = np.zeros((B, N), bool)
    for b in range(B):
        mask[b, rng.choice(N, int(rng.integers(8, M + 1)), replace=False)] = True
    return mask


def _pair(rng, **over):
    kw = dict(_KW, **over)
    fmodel = jax_create_model("pt_vit", dtype=jnp.float32, **kw)
    variables = jax.jit(fmodel.init)(jax.random.key(0), jnp.zeros((2, 32, 32, 3)),
                                     jnp.zeros((2, 64), bool))

    def redraw(path, leaf):
        base = 1.0 if "scale" in jax.tree_util.keystr(path) else 0.0
        return jnp.asarray(base + 0.2 * rng.standard_normal(leaf.shape), jnp.float32)

    variables = jax.device_get(jax.tree_util.tree_map_with_path(redraw, variables))
    tmodel = create_model("pt_vit", **kw)
    tmodel.load_state_dict(from_jax_params(variables), strict=True)
    return fmodel, variables, tmodel


def test_from_jax_params_pt_vit_equals_export_vit_params(rng):
    _, variables, tmodel = _pair(rng, use_abs_pos_emb=True)
    want = export_vit_params(variables)
    got = from_jax_params(variables)
    assert set(got) == set(want) == set(tmodel.state_dict())
    assert {"mask_token", "lm_head.weight", "lm_head.bias", "pos_embed"} <= set(got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("gathered", [True, False])
def test_forward_and_ce_gradient_match_flax(rng, monkeypatch, gathered):
    """f32 on both sides, drop-path 0: logits to 1e-5 (sums reordered over
    two blocks), idx exactly, and every parameter's gradient of the masked
    CE to 1e-4 relative L2."""
    monkeypatch.setattr(jax_attention, "ENABLED", True)
    over = {} if gathered else {"num_masked_tokens": None}
    fmodel, variables, tmodel = _pair(rng, **over)
    x = rng.random((3, 32, 32, 3)).astype(np.float32)
    mask = _mask(rng, 3)
    labels = rng.integers(0, 16, (3, 64))

    def jloss(v):
        out = fmodel.apply(v, jnp.asarray(x), jnp.asarray(mask))
        if gathered:
            return jax_pretrain.masked_cross_entropy_gathered(*out, jnp.asarray(labels),
                                                              jnp.asarray(mask))
        return jax_pretrain.masked_cross_entropy(out, jnp.asarray(labels), jnp.asarray(mask))

    (jl, jacc), jgrads = jax.value_and_grad(jloss, has_aux=True)(variables)
    jout = fmodel.apply(variables, jnp.asarray(x), jnp.asarray(mask))

    tmodel.train()
    out = tmodel(torch.from_numpy(x), torch.from_numpy(mask))
    if gathered:
        logits, idx = out
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jout[1]))
        np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jout[0]),
                                   rtol=0, atol=1e-5)
        loss, acc = pretrain.masked_cross_entropy_gathered(
            logits, idx, torch.from_numpy(labels), torch.from_numpy(mask))
    else:
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0, atol=1e-5)
        loss, acc = pretrain.masked_cross_entropy(out, torch.from_numpy(labels),
                                                  torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    assert acc.item() == pytest.approx(float(jacc))
    want = from_jax_params(jax.device_get(jgrads))
    for name, p in tmodel.named_parameters():
        w = want[name].numpy()
        rel = np.linalg.norm(p.grad.numpy() - w) / max(np.linalg.norm(w), 1e-12)
        assert rel < 1e-4, (name, rel)


def test_masked_cross_entropy_forms_match_jax(rng):
    logits = rng.standard_normal((2, 64, 16)).astype(np.float32) * 3
    labels = rng.integers(0, 16, (2, 64))
    mask = _mask(rng, 2)
    want = jax_pretrain.masked_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                             jnp.asarray(mask))
    got = pretrain.masked_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                        torch.from_numpy(mask))
    for g, w in zip(got, want):
        assert g.item() == pytest.approx(float(w), rel=1e-6)
    # the gathered form on the first 20 slots of the masked-first order
    order = np.argsort(np.where(mask, 0, 1), axis=1, kind="stable")[:, :20]
    lg = np.take_along_axis(logits, order[..., None], axis=1)
    want_g = jax_pretrain.masked_cross_entropy_gathered(
        jnp.asarray(lg), jnp.asarray(order), jnp.asarray(labels), jnp.asarray(mask))
    got_g = pretrain.masked_cross_entropy_gathered(
        torch.from_numpy(lg), torch.from_numpy(order), torch.from_numpy(labels),
        torch.from_numpy(mask))
    for g, w, full in zip(got_g, want_g, got):
        assert g.item() == pytest.approx(float(w), rel=1e-6)
        assert g.item() == pytest.approx(full.item(), rel=1e-6)


def test_drop_path_is_per_sample_and_rescaled():
    x = torch.arange(1, 1 + 64 * 5 * 3, dtype=torch.float32).reshape(64, 5, 3)
    g = torch.Generator().manual_seed(0)
    y = drop_path(x, 0.25, g)
    kept = [bool((y[b] != 0).any()) for b in range(64)]
    for b in range(64):
        if kept[b]:
            torch.testing.assert_close(y[b], x[b] / 0.75, rtol=0, atol=0)
        else:
            assert (y[b] == 0).all()
    assert 0 < sum(kept) < 64
    torch.testing.assert_close(drop_path(x, 0.25, torch.Generator().manual_seed(0)), y)


@pytest.mark.parametrize("depth", [1, 2, 12])
def test_drop_path_schedule(depth):
    want = [0.1 * i / max(depth - 1, 1) for i in range(depth)]
    assert drop_path_rates(0.1, depth) == want
    enc = VitEncoder(16, depth, 2, drop_path_rate=0.1)
    assert [b.drop_path_rate for b in enc.blocks] == want


def test_training_randomness_needs_a_generator_and_attn_dropout_raises():
    model = create_model("pt_vit", drop_path_rate=0.1, **_KW).train()
    x, mask = torch.rand(2, 32, 32, 3), torch.zeros(2, 64, dtype=torch.bool)
    with pytest.raises(ValueError, match="Generator"):
        model(x, mask)
    a = model(x, mask, generator=torch.Generator().manual_seed(3))[0]
    b = model(x, mask, generator=torch.Generator().manual_seed(3))[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    # attention dropout takes the einsum path: it builds, and in training
    # mode it raises without a generator like every other random op
    drop = create_model("pt_vit", attn_drop_rate=0.1, **_KW).train()
    with pytest.raises(ValueError, match="attention dropout.*Generator"):
        drop(x, mask)
    c = drop(x, mask, generator=torch.Generator().manual_seed(3))[0]
    assert torch.isfinite(c).all()
