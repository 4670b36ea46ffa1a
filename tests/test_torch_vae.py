"""The port's frozen VAE encoder (models/discrete_vae.py) held against the
flax DiscreteVAE with the same weights: the weight transfer into the
reference state_dict schema and back, the encoder logits and the codebook
indices."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mem_tpu.models.discrete_vae import DiscreteVAE as JaxDiscreteVAE
from mem_tpu.utils.torch_import import import_vae_state_dict
from mem_tpu_torch.models.discrete_vae import DiscreteVAE
from mem_tpu_torch.utils.weights import vae_from_jax_params

_KW = dict(num_tokens=32, codebook_dim=8, num_layers=2, hidden_dim=16)


def _pair(rng, num_resnet_blocks=1):
    fvae = JaxDiscreteVAE(input_hw=(32, 32), num_resnet_blocks=num_resnet_blocks, **_KW)
    variables = jax.jit(fvae.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))

    def redraw(leaf):   # non-zero biases; He-scaled kernels keep logits O(1)
        if leaf.ndim == 1:
            return jnp.asarray(0.1 * rng.standard_normal(leaf.shape), jnp.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return jnp.asarray(rng.standard_normal(leaf.shape) * np.sqrt(2.0 / fan_in), jnp.float32)

    variables = jax.device_get(jax.tree.map(redraw, variables))
    tvae = DiscreteVAE((32, 32), num_resnet_blocks=num_resnet_blocks, **_KW)
    tvae.load_state_dict(vae_from_jax_params(variables), strict=True)
    return fvae, variables, tvae


@pytest.mark.parametrize("num_resnet_blocks", [0, 1, 2])
def test_vae_from_jax_params_round_trips(rng, num_resnet_blocks):
    _, variables, _ = _pair(rng, num_resnet_blocks)
    sd = vae_from_jax_params(variables)
    back = import_vae_state_dict(sd, num_layers=2, num_resnet_blocks=num_resnet_blocks)
    flat_want = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], leaf, err_msg=jax.tree_util.keystr(path))


def test_encoder_logits_and_indices_match_flax(rng):
    """f32 on both sides: logits to 1e-5 (conv sums in another order);
    indices equal wherever the top-2 logit gap exceeds 1e-4."""
    fvae, variables, tvae = _pair(rng)
    img = rng.random((3, 32, 32, 3)).astype(np.float32)
    want = np.asarray(fvae.apply(variables, jnp.asarray(img), method="encode_logits"))
    want_idx = np.asarray(fvae.apply(variables, jnp.asarray(img),
                                     method="get_codebook_indices"))
    with torch.no_grad():
        got = tvae.encode_logits(torch.from_numpy(img)).numpy()
        got_idx = tvae.get_codebook_indices(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (3, 8, 8, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    top2 = np.sort(want, axis=-1)[..., -2:].reshape(3, -1, 2)
    clear = (top2[..., 1] - top2[..., 0]) > 1e-4
    assert clear.mean() > 0.9 and len(np.unique(want_idx)) > 4
    np.testing.assert_array_equal(got_idx[clear], want_idx[clear])


def test_load_requires_every_encoder_key(rng):
    _, variables, tvae = _pair(rng)
    sd = vae_from_jax_params(variables)
    del sd["encoder.2.net.0.weight"]
    with pytest.raises(RuntimeError, match="encoder.2.net.0.weight"):
        tvae.load_state_dict(sd, strict=True)


def test_init_weights_draws_flax_defaults():
    """init_weights follows flax's conv defaults (lecun-normal kernels, zero
    biases), is a function of the generator's seed, and gives a mostly empty
    event image more than one token (PyTorch's default init does not)."""
    vae = DiscreteVAE((32, 32), num_resnet_blocks=1, **_KW)
    vae.init_weights(torch.Generator().manual_seed(0))
    again = DiscreteVAE((32, 32), num_resnet_blocks=1, **_KW)
    again.init_weights(torch.Generator().manual_seed(0))
    for (name, p), q in zip(vae.state_dict().items(), again.state_dict().values()):
        assert torch.equal(p, q), name
        if name.startswith("encoder.") and name.endswith("bias"):
            assert not p.any(), name
        elif name.startswith("encoder."):
            fan_in = p[0].numel()   # truncated at 2 std: |w| <= 2.28 / sqrt(fan_in)
            assert abs(p.std().item() * fan_in ** 0.5 - 1.0) < 0.15, name
            assert p.abs().max().item() * fan_in ** 0.5 <= 2.0 / 0.8796 + 1e-4, name
    img = torch.zeros(2, 32, 32, 3)
    img[:, 8:24, 8:24] = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert vae.get_codebook_indices(img).unique().numel() > 4
