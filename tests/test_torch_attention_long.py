"""The port's plain ``fused_attention_flat_long`` (K3f's plain version) held
against the JAX package's Pallas kernel in interpret mode, and the rule that
routes a sequence to K2f or K3f. f32 tolerance 1e-5: the same arithmetic,
sums taken in another order."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mem_tpu.ops.attention import fused_attention_flat_long as jax_flat_long
from mem_tpu_torch.models import vit
from mem_tpu_torch.ops import attention as A

F32_TOL = 1e-5


def _operands(rng, B, N, H, D):
    q, k, v = (rng.standard_normal((B, N, H * D)).astype(np.float32) for _ in range(3))
    bias = (0.1 * rng.standard_normal((H, N, N))).astype(np.float32)
    return q, k, v, bias


@pytest.mark.parametrize("B,N,H,D", [(2, 300, 2, 8), (1, 130, 3, 16)])
def test_flat_long_plain_matches_pallas_interpret(rng, B, N, H, D):
    q, k, v, bias = _operands(rng, B, N, H, D)
    scale = D ** -0.5
    want = np.asarray(jax.jit(lambda *a: jax_flat_long(*a, scale, True))(
        *(jnp.asarray(t) for t in (q, k, v, bias))))
    tq, tk, tv, tb = (torch.from_numpy(t) for t in (q, k, v, bias))
    got = A.fused_attention_flat_long_reference(tq, tk, tv, tb, scale)
    assert got.shape == (B, N, H * D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)
    # on CPU tensors the wrapper takes the plain version
    assert torch.equal(A.fused_attention_flat_long(tq, tk, tv, tb, scale), got)


def test_flat_long_bf16_rounds_as_the_kernel(rng):
    """bf16 operands: p is normalised in f32 and then rounded to bf16, the
    output is bf16 (attention.py:266-273); held against an f32 evaluation
    within bf16 rounding of |o| <= 1 (2^-8 from o, 2^-9 relative from p)."""
    q, k, v, bias = _operands(rng, 2, 96, 2, 16)
    tq, tk, tv = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    tb = torch.from_numpy(bias)
    got = A.fused_attention_flat_long(tq, tk, tv, tb, 0.25)
    assert got.dtype == torch.bfloat16
    want = A.fused_attention_flat_long_reference(tq.float(), tk.float(), tv.float(), tb, 0.25)
    assert (got.float() - want).abs().max().item() <= 1e-2


def test_flat_long_backward_raises(rng):
    """The backward is kernel K3b, which comes with the train_seg slice."""
    q, k, v, bias = (torch.from_numpy(t).requires_grad_() for t in _operands(rng, 1, 40, 2, 8))
    out = A.fused_attention_flat_long(q, k, v, bias, 0.35)
    with pytest.raises(NotImplementedError, match="K3b"):
        out.sum().backward()


@pytest.mark.parametrize("N,want", [(197, "flat"), (50, "flat"), (256, "flat"),
                                    (257, "long"), (577, "long"), (1025, "long")])
def test_attention_route(N, want):
    assert A.attention_route(N) == want


@pytest.mark.parametrize("N,want", [(17, "flat"), (300, "long")])
def test_vit_attention_routes_on_length(monkeypatch, N, want):
    """models.vit.Attention sends short sequences through
    fused_attention_flat and long ones through fused_attention_flat_long."""
    calls = []
    monkeypatch.setattr(vit, "fused_attention_flat",
                        lambda q, *a: calls.append("flat") or q)
    monkeypatch.setattr(vit, "fused_attention_flat_long",
                        lambda q, *a: calls.append("long") or q)
    attn = vit.Attention(16, 2)
    attn(torch.zeros(1, N, 16))
    assert calls == [want]
