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

from chip_smoke import K2_BF16_TOL, K2_F32_TOL, K2B_BF16_TOL, K2B_DB_REL, K2B_F32_TOL
from mem_tpu.ops.attention import fused_attention_flat as jax_fused_attention_flat
from mem_tpu_torch.ops.attention import (fused_attention_flat, fused_attention_flat_bwd,
                                         fused_attention_flat_bwd_reference,
                                         fused_attention_flat_reference)
from test_torch_attention_long import _one_pass, _two_sided

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


# the lengths K2 takes K3's Hopper kernels at: ragged against the 64-row tile
# (37 keys in one tile, 197 = 3 x 64 + 5), and the longest (four full tiles)
_SHORT_N = [(N, dtype) for N in (37, 197, 256) for dtype in ("bfloat16", "float32")]


@pytest.mark.parametrize("N,dtype", _SHORT_N)
def test_hopper_forward_order_matches_pallas_interpret(rng, N, dtype):
    """K2f launches K3f's wgmma kernel for bf16 at head dim 64 and N <= 256:
    K3f's one-pass order (test_torch_attention_long._one_pass: an online
    softmax over 64-key tiles, the unnormalised p rounded to bf16 where the
    plain version rounds the normalised one) at those N, held
    against the Pallas kernel in interpret mode on the same operands (B = 2,
    H = 2, D = 64) within the card's gates (chip_smoke.K2_BF16_TOL, 2e-2
    absolute, in bf16; chip_smoke.K2_F32_TOL in f32)."""
    B, H, D = 2, 2, 64
    q, k, v, bias = _inputs(rng, B, N, H, D)
    scale = D ** -0.5
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    want = jax_fused_attention_flat(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                    jnp.asarray(bias), scale, True)
    got, _ = _one_pass(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                       torch.from_numpy(bias), scale)
    assert got.dtype == tdt and got.shape == (B, N, H * D)
    tol = K2_BF16_TOL if dtype == "bfloat16" else K2_F32_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("N,dtype", _SHORT_N)
def test_hopper_backward_order_matches_pallas_vjp(rng, N, dtype):
    """K2b launches K3b's rows and columns kernels for bf16 at head dim 64
    and N <= 256: K3b's two-sided order
    (test_torch_attention_long._two_sided: row statistics in an online pass,
    then ds and dq; dk and dv rebuilt from the statistics) at those N, held
    against ``jax.vjp`` of the Pallas kernel in interpret mode on the same
    operands (B = 2, H = 2, D = 64) within the card's gates
    (chip_smoke.K2B_BF16_TOL / K2B_F32_TOL of each gradient's max abs, db
    chip_smoke.K2B_DB_REL relative L2), db also against the plain
    backward's, the comparison the card makes."""
    B, H, D = 2, 2, 64
    q, k, v, bias = _inputs(rng, B, N, H, D)
    do = rng.standard_normal((B, N, H * D)).astype(np.float32)
    scale = D ** -0.5
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    _, vjp = jax.vjp(lambda a, b, c, d: jax_fused_attention_flat(a, b, c, d, scale, True),
                     *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(bias))
    want = [np.asarray(w.astype(jnp.float32)) for w in vjp(jnp.asarray(do, jdt))]
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    tb = torch.from_numpy(bias)
    *got, _ = _two_sided(tq, tk, tv, tb, tdo, scale)
    tol = K2B_BF16_TOL if dtype == "bfloat16" else K2B_F32_TOL
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt and tuple(g.shape) == w.shape, name
        assert np.abs(g.float().numpy() - w).max() <= tol * np.abs(w).max(), name
    db = got[3].numpy()
    plain_db = fused_attention_flat_bwd_reference(tq, tk, tv, tb, tdo, scale)[3].numpy()
    for ref in (want[3], plain_db):
        assert np.linalg.norm(db - ref) <= K2B_DB_REL * np.linalg.norm(ref)
