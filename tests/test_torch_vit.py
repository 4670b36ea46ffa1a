"""The port's ft_vit held against the flax VisionTransformer with the same
weights: weight transfer (from_jax_params vs export_vit_params, strict
load), the relative-position index, and the logits in f32 and bf16. The
flax side runs its attention through the Pallas K2 kernel in interpret
mode (attention.ENABLED), as it would route on an accelerator."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mem_tpu.ops.attention as jax_attention
from mem_tpu.models.registry import create_model as jax_create_model
from mem_tpu.models.vit import relative_position_index as jax_relative_position_index
from mem_tpu.utils.torch_import import export_vit_params
from mem_tpu_torch.models.registry import create_model
from mem_tpu_torch.models.vit import relative_position_index
from mem_tpu_torch.utils.weights import from_jax_params

_CONFIGS = {
    # the serving default: per-block rel-pos bias, mean pooling + fc_norm
    "rel_pos_mean_pool": dict(),
    # cls readout after norm, learned abs pos-emb, one shared rel-pos table
    "cls_readout_abs_pos_shared_rel": dict(use_mean_pooling=False, use_abs_pos_emb=True,
                                           use_rel_pos_bias=False,
                                           use_shared_rel_pos_bias=True),
    # linear probe: affine-free BatchNorm on running statistics
    "batch_norm_probe": dict(use_batch_norm=True),
}


def _kwargs(**over):
    kw = dict(num_classes=5, img_size=(32, 48), patch_size=(16, 16), in_chans=3,
              embed_dim=32, depth=2, num_heads=4, init_values=0.1)
    kw.update(over)
    return kw


def _flax_variables(model, rng):
    """flax init, then every leaf redrawn from numpy so no bias, table or
    LayerScale is trivially zero or one."""
    variables = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 32, 48, 3)))

    def redraw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "var" in name:
            return jnp.asarray(1.0 + 0.5 * rng.random(leaf.shape), jnp.float32)
        base = 1.0 if "scale" in name else 0.0
        return jnp.asarray(base + 0.2 * rng.standard_normal(leaf.shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(redraw, jax.device_get(variables))


def _pair(rng, dtype_j, dtype_t, **over):
    kw = _kwargs(**over)
    fmodel = jax_create_model("ft_vit", dtype=dtype_j, **kw)
    variables = _flax_variables(fmodel, rng)
    tmodel = create_model("ft_vit", dtype=dtype_t, **kw)
    tmodel.load_state_dict(from_jax_params(jax.device_get(variables)), strict=True)
    return fmodel, variables, tmodel.eval()


@pytest.mark.parametrize("config", sorted(_CONFIGS))
def test_from_jax_params_equals_export_vit_params(rng, config):
    fmodel = jax_create_model("ft_vit", **_kwargs(**_CONFIGS[config]))
    variables = jax.device_get(_flax_variables(fmodel, rng))
    want = export_vit_params(variables)
    got = from_jax_params(variables)
    bn = {k for k in got if k.startswith("batch_norm.")}
    assert set(got) - bn == set(want)       # export_vit_params drops batch_stats
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    # the port's module tree takes the reference schema as it is
    tmodel = create_model("ft_vit", **_kwargs(**_CONFIGS[config]))
    tmodel.load_state_dict(got, strict=True)
    assert set(tmodel.state_dict()) == set(got)


@pytest.mark.parametrize("config", sorted(_CONFIGS))
def test_logits_f32_match_flax(rng, monkeypatch, config):
    monkeypatch.setattr(jax_attention, "ENABLED", True)   # flax takes K2 (interpret)
    fmodel, variables, tmodel = _pair(rng, jnp.float32, torch.float32, **_CONFIGS[config])
    x = rng.random((3, 32, 48, 3)).astype(np.float32)
    want = np.asarray(fmodel.apply(variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_logits_bf16_match_flax(rng, monkeypatch):
    """bf16 compute, f32 params on both sides. The two frameworks round to
    bf16 at different places (XLA fuses elementwise chains and rounds once;
    eager torch rounds after every op), so the residual stream differs by
    about one bf16 ulp (2^-8 relative) here and there. Measured over three
    seeds: max abs <= 5.1e-3 and relative L2 <= 2.2e-3 on logits of std
    0.6-0.8. Bound: 2e-2 max abs and 1e-2 relative L2, ~4x the worst seen."""
    monkeypatch.setattr(jax_attention, "ENABLED", True)
    fmodel, variables, tmodel = _pair(rng, jnp.bfloat16, torch.bfloat16)
    x = rng.random((3, 32, 48, 3)).astype(np.float32)
    want = np.asarray(fmodel.apply(variables, jnp.asarray(x)), np.float32)
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-2


@pytest.mark.parametrize("window", [(2, 3), (14, 14), (1, 1)])
def test_relative_position_index_equal(window):
    np.testing.assert_array_equal(relative_position_index(window),
                                  jax_relative_position_index(window))
