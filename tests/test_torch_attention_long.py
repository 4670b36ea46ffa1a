"""The port's plain ``fused_attention_flat_long`` (K3f's plain version) and
its plain backward (K3b's) held against the JAX package's Pallas kernels in
interpret mode, and the rule that routes a sequence to K2f or K3f. f32
tolerance 1e-5: the same arithmetic, sums taken in another order."""
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


def _jax_vjp(q, k, v, bias, do, scale):
    """dq, dk, dv, db of the Pallas kernels in interpret mode (K3b under
    ``jax.vjp`` of fused_attention_flat_long, as tests/test_attention_kernel.py
    runs it)."""
    def f(q, k, v, bias):
        return jax_flat_long(q, k, v, bias, scale, True)

    _, vjp = jax.vjp(f, *(jnp.asarray(t) for t in (q, k, v, bias)))
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("B,N,H,D", [(2, 300, 2, 8), (1, 321, 3, 16)])
def test_flat_long_bwd_plain_matches_pallas_interpret(rng, B, N, H, D):
    """f32, N > 256 and no multiple of 64 (the TPU kernel pads to 512 and
    masks): each gradient within 1e-5 of its own max abs."""
    q, k, v, bias = _operands(rng, B, N, H, D)
    do = rng.standard_normal((B, N, H * D)).astype(np.float32)
    scale = D ** -0.5
    want = _jax_vjp(q, k, v, bias, do, scale)
    tq, tk, tv, tb, tdo = (torch.from_numpy(t) for t in (q, k, v, bias, do))
    got = A.fused_attention_flat_long_bwd_reference(tq, tk, tv, tb, tdo, scale)
    for name, g, w in zip(("dq", "dk", "dv", "db"), got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=F32_TOL * np.abs(w).max(),
                                   err_msg=name)
    # on CPU tensors the wrapper takes the plain version
    for g, w in zip(A.fused_attention_flat_long_bwd(tq, tk, tv, tb, tdo, scale), got):
        assert torch.equal(g, w)


def test_flat_long_bwd_bf16_matches_pallas_interpret(rng):
    """bf16 operands: dq/dk/dv come back in bf16 within 2e-2 of the Pallas
    kernel's max abs (both round p, ds and the outputs to bf16; the TPU kernel
    also rounds each 256-row dk/dv partial, which the port does not), db in
    f32 within 1e-2 relative L2 (bf16 products under f32 sums on both sides,
    taken in another order)."""
    B, N, H, D = 2, 300, 2, 16
    q, k, v, bias = _operands(rng, B, N, H, D)
    do = rng.standard_normal((B, N, H * D)).astype(np.float32)
    bf = lambda t: jnp.asarray(t).astype(jnp.bfloat16)  # noqa: E731
    _, vjp = jax.vjp(lambda q, k, v, b: jax_flat_long(q, k, v, b, 0.25, True),
                     bf(q), bf(k), bf(v), jnp.asarray(bias))
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(bf(do))]
    tb16 = lambda t: torch.from_numpy(t).to(torch.bfloat16)  # noqa: E731
    got = A.fused_attention_flat_long_bwd(tb16(q), tb16(k), tb16(v), torch.from_numpy(bias),
                                          tb16(do), 0.25)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16, name
        assert np.abs(g.float().numpy() - w).max() <= 2e-2 * np.abs(w).max(), name
    assert got[3].dtype == torch.float32
    assert np.linalg.norm(got[3].numpy() - want[3]) <= 1e-2 * np.linalg.norm(want[3])


@pytest.mark.parametrize("B,N,H,D", [(2, 70, 2, 8), (1, 260, 3, 4)])
def test_flat_long_function_agrees_with_autograd_of_plain_forward(rng, B, N, H, D):
    """The Function's hand-written backward against autograd through the
    plain forward, in f32 (the plain versions compute in f32 whatever they
    are given): each gradient within 1e-5 of its max abs."""
    arrays = _operands(rng, B, N, H, D)
    do = torch.from_numpy(rng.standard_normal((B, N, H * D)).astype(np.float32))

    def grads(fn):
        ts = [torch.from_numpy(t).requires_grad_() for t in arrays]
        return torch.autograd.grad(fn(*ts), ts, do)

    got = grads(lambda q, k, v, b: A.fused_attention_flat_long(q, k, v, b, 0.35))
    want = grads(lambda q, k, v, b: A.fused_attention_flat_long_reference(q, k, v, b, 0.35))
    for name, g, w in zip(("dq", "dk", "dv", "db"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert (g - w).abs().max().item() <= F32_TOL * w.abs().max().item(), name


def test_flat_long_backward_raises(rng):
    """The backward takes its plain version for CPU tensors only: tensors on
    any other device that is no CUDA device raise rather than fall back."""
    q, k, v, bias = (torch.from_numpy(t).to("meta") for t in _operands(rng, 1, 40, 2, 8))
    with pytest.raises(ValueError, match="CUDA device"):
        A.fused_attention_flat_long_bwd(q, k, v, bias, q, 0.35)
    with pytest.raises(ValueError, match="CUDA device"):
        A.fused_attention_flat_long(q, k, v, bias, 0.35)


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
