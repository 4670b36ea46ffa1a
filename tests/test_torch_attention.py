"""The port's flat fused attention (the plain versions of K2f and K2b) held
against mem_tpu.ops.attention.fused_attention_flat and its VJP in interpret
mode, the autograd wiring, and the wrappers' device dispatch. The CUDA
kernels themselves are held against the plain versions on the card by
chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mem_tpu.ops.attention import fused_attention_flat as jax_fused_attention_flat
from mem_tpu_torch.ops.attention import (fused_attention_flat, fused_attention_flat_bwd,
                                         fused_attention_flat_bwd_reference,
                                         fused_attention_flat_reference)

# f32: same math, sums in another order -> 1e-5 max abs.
# bf16: inputs rounded to bf16 on both sides, p rounded to bf16 before PV
# and the output rounded to bf16 -> a few bf16 ulps at |o| <= 2: 2e-2 max abs.
_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(rng, B, N, H, D):
    q, k, v = (rng.standard_normal((B, N, H * D)).astype(np.float32) for _ in range(3))
    bias = (rng.standard_normal((H, N, N)) * 0.5).astype(np.float32)
    return q, k, v, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,H,D", [(2, 24, 3, 8), (1, 37, 2, 16)])
def test_reference_matches_jax_interpret(rng, dtype, B, N, H, D):
    q, k, v, bias = _inputs(rng, B, N, H, D)
    scale = D ** -0.5
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jax_fused_attention_flat(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                    jnp.asarray(bias), scale, True)
    want = np.asarray(want.astype(jnp.float32))
    got = fused_attention_flat_reference(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                         torch.from_numpy(bias), scale)
    assert got.dtype == tdt and got.shape == (B, N, H * D)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=_TOL[dtype])


def test_cpu_wrapper_takes_plain_version(rng):
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(rng, 2, 11, 2, 8))
    torch.testing.assert_close(fused_attention_flat(q, k, v, bias, 0.3),
                               fused_attention_flat_reference(q, k, v, bias, 0.3),
                               rtol=0, atol=0)


def test_non_cuda_device_raises():
    """Only CPU tensors take the plain version: any other device must reach
    the kernel or raise, never fall back."""
    q = torch.empty(1, 4, 8, device="meta")
    bias = torch.empty(2, 4, 4, device="meta")
    with pytest.raises(ValueError):
        fused_attention_flat(q, q, q, bias, 0.5)


def test_kernel_library_needs_a_cuda_device():
    """The build refuses to run without a card (it never builds or loads a
    library a CPU run could then mistake for a kernel)."""
    from mem_tpu_torch.kernels import build

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        build.library()


# K2b. f32: the same math, sums in another order -> 1e-5 max abs. bf16: both
# round p and ds to bf16 and the outputs to bf16 from f32 sums; measured
# equal to the bit here, bound at 2 bf16 ulps of |grad| <= 2: 2e-2 max abs.
# db stays f32 on both sides: 1e-5 max abs for either dtype.
_BWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,H,D", [(2, 24, 3, 8), (1, 37, 2, 16)])
def test_bwd_reference_matches_jax_vjp(rng, dtype, B, N, H, D):
    q, k, v, bias = _inputs(rng, B, N, H, D)
    do = rng.standard_normal((B, N, H * D)).astype(np.float32)
    scale = D ** -0.5
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    _, vjp = jax.vjp(lambda a, b, c, d: jax_fused_attention_flat(a, b, c, d, scale, True),
                     *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(bias))
    want = vjp(jnp.asarray(do, jdt))
    got = fused_attention_flat_bwd_reference(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                             torch.from_numpy(bias),
                                             torch.from_numpy(do).to(tdt), scale)
    for name, w, g, tol in zip(("dq", "dk", "dv", "db"), want, got,
                               (_BWD_TOL[dtype],) * 3 + (1e-5,)):
        assert g.dtype == (torch.float32 if name == "db" else tdt), name
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w.astype(jnp.float32)),
                                   rtol=0, atol=tol, err_msg=name)


def test_cpu_autograd_equals_plain_backward(rng):
    q, k, v, bias = (torch.from_numpy(a).requires_grad_() for a in _inputs(rng, 2, 13, 2, 8))
    do = torch.from_numpy(rng.standard_normal((2, 13, 16)).astype(np.float32))
    fused_attention_flat(q, k, v, bias, 0.3).backward(do)
    want = fused_attention_flat_bwd_reference(q.detach(), k.detach(), v.detach(),
                                              bias.detach(), do, 0.3)
    for t, w in zip((q, k, v, bias), want):
        torch.testing.assert_close(t.grad, w, rtol=0, atol=0)
    got = fused_attention_flat_bwd(q.detach(), k.detach(), v.detach(), bias.detach(), do, 0.3)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_bwd_non_cuda_device_raises():
    q = torch.empty(1, 4, 8, device="meta")
    bias = torch.empty(2, 4, 4, device="meta")
    with pytest.raises(ValueError):
        fused_attention_flat_bwd(q, q, q, bias, q, 0.5)
