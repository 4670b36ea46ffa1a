"""The head-major attention of the port (ops/attention.py ``fused_attention``,
kernels K5a/K5c) held against the reference's ``fused_attention`` on
(B, H, N, D), whose head-blocked Pallas kernels run in interpret mode: the
plain versions (the CPU path, and what the card comparisons use) against
the kernel's forward and its VJP, the routing rule, and the refusal of
shapes whose kernels are not ported."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mem_tpu.ops.attention as jax_attention
from mem_tpu_torch.ops import attention as A

# (B, H, N, D): the finetune's 197 tokens at a narrow width, and a small N
_SHAPES = {"n197": (2, 3, 197, 16), "n10": (3, 4, 10, 8)}


def _operands(rng, shape):
    B, H, N, D = shape
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    bias = rng.standard_normal((H, N, N)).astype(np.float32)
    return q, k, v, bias, do, float(D) ** -0.5


@pytest.mark.parametrize("shape", sorted(_SHAPES))
def test_forward_matches_pallas_kernel(rng, shape):
    """f32, 1e-5: the same function with sums in another order."""
    q, k, v, bias, _, scale = _operands(rng, _SHAPES[shape])
    assert jax_attention._hb_eligible(*_SHAPES[shape][1:3])     # K5a's branch, not K5b's
    want = jax_attention.fused_attention(*(jnp.asarray(a) for a in (q, k, v, bias)), scale, True)
    got = A.fused_attention(*(torch.from_numpy(a) for a in (q, k, v, bias)), scale)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("shape", sorted(_SHAPES))
def test_gradients_match_pallas_vjp(rng, shape):
    """dq, dk, dv and the batch-summed db through ``torch.autograd`` against
    ``jax.vjp`` of the kernel (interpret), f32, 1e-5."""
    q, k, v, bias, do, scale = _operands(rng, _SHAPES[shape])
    _, vjp = jax.vjp(lambda *a: jax_attention.fused_attention(*a, scale, True),
                     *(jnp.asarray(a) for a in (q, k, v, bias)))
    want = vjp(jnp.asarray(do))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    A.fused_attention(*ts, scale).backward(torch.from_numpy(do))
    for t, w, name in zip(ts, want, ("dq", "dk", "dv", "db")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5, err_msg=name)
    assert ts[3].grad.shape == bias.shape and ts[3].grad.dtype == torch.float32


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_plain_versions_equal_the_flat_ones_on_transposed_operands(rng, dt):
    """K5a/K5c compute K2f/K2b's function in another layout: the plain
    versions agree exactly, roundings included."""
    B, H, N, D = 2, 3, 21, 8
    q, k, v, bias, do, scale = _operands(rng, (B, H, N, D))
    q, k, v, do = (torch.from_numpy(a).to(dt) for a in (q, k, v, do))
    bias = torch.from_numpy(bias)
    flat = lambda t: t.transpose(1, 2).reshape(B, N, H * D)
    torch.testing.assert_close(flat(A.fused_attention_reference(q, k, v, bias, scale)),
                               A.fused_attention_flat_reference(flat(q), flat(k), flat(v),
                                                                bias, scale), rtol=0, atol=0)
    got = A.fused_attention_bwd_reference(q, k, v, bias, do, scale)
    want = A.fused_attention_flat_bwd_reference(flat(q), flat(k), flat(v), bias, flat(do), scale)
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(flat(g), w, rtol=0, atol=0)
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=0)


@pytest.mark.parametrize("H,N", [(12, 197), (12, 320), (12, 321), (12, 1025), (1, 1144),
                                 (1, 1145), (4, 448), (16, 197)])
def test_routing_rule_is_the_reference_s(H, N):
    assert A._hb_eligible(H, N) == jax_attention._hb_eligible(H, N)
    assert A._HB_MAX_BIAS_BYTES == jax_attention._HB_MAX_BIAS_BYTES


@pytest.mark.parametrize("H,N", [(12, 1025), (12, 400)])
def test_shapes_that_are_not_head_blocked_raise(H, N):
    """N = 1025 with ``FLAT_ATTN_LONG = False`` and 320 < N <= 448 reach the
    reference's K5b/K5d/K5e; the port has not ported those and takes no silent
    route to the flat kernels."""
    q = torch.zeros(1, H, N, 8)
    bias = torch.zeros(H, N, N)
    with pytest.raises(NotImplementedError, match="K5b.*K5d.*K5e.*slice 6"):
        A.fused_attention(q, q, q, bias, 1.0)
    with pytest.raises(NotImplementedError, match="K5b"):
        A.fused_attention_bwd(q, q, q, bias, q, 1.0)


def test_wrappers_never_take_the_plain_version_off_the_cpu():
    q = torch.empty(1, 2, 10, 8, device="meta")
    bias = torch.empty(2, 10, 10, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        A.fused_attention(q, q, q, bias, 1.0)
    with pytest.raises(ValueError, match="CUDA device"):
        A.fused_attention_bwd(q, q, q, bias, q, 1.0)
