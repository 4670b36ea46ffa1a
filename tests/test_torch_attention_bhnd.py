"""The head-major attention of the port (ops/attention.py ``fused_attention``,
kernels K5a-K5e) held against the reference's ``fused_attention`` on
(B, H, N, D), whose Pallas kernels run in interpret mode: the plain versions
(the CPU path, and what the card comparisons use) against the kernels'
forward and their VJP on every branch -- head-blocked (K5a/K5c), per
(b, h) (K5b), whole-matrix backward (K5d) and row-blocked backward (K5e) --
and the head-blocked-eligibility rule."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mem_tpu.ops.attention as jax_attention
from chip_smoke import K2_BF16_TOL, K2_F32_TOL, K2B_BF16_TOL, K2B_DB_REL, K2B_F32_TOL
from mem_tpu_torch.ops import attention as A
from test_torch_attention import _SHORT_N
from test_torch_attention_long import _one_pass, _two_sided

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


def test_wrappers_never_take_the_plain_version_off_the_cpu():
    q = torch.empty(1, 2, 10, 8, device="meta")
    bias = torch.empty(2, 10, 10, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        A.fused_attention(q, q, q, bias, 1.0)
    with pytest.raises(ValueError, match="CUDA device"):
        A.fused_attention_bwd(q, q, q, bias, q, 1.0)


@pytest.mark.parametrize("H,N", [(12, 401), (12, 1025)], ids=["k5b_k5d", "k5b_k5e"])
def test_ineligible_wrappers_never_take_the_plain_version_off_the_cpu(H, N):
    q = torch.empty(1, H, N, 8, device="meta")
    bias = torch.empty(H, N, N, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        A.fused_attention(q, q, q, bias, 1.0)
    with pytest.raises(ValueError, match="CUDA device"):
        A.fused_attention_bwd(q, q, q, bias, q, 1.0)


# -- the branches of shapes that are not head-blocked-eligible ------------------

F32_TOL = 1e-5


def _jax_vjp(q, k, v, bias, do, scale):
    _, vjp = jax.vjp(lambda *a: jax_attention.fused_attention(*a, scale, True),
                     *(jnp.asarray(a) for a in (q, k, v, bias)))
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do))]


# (B, H, N, D), the head-blocked budget patched to 0 on both sides or not, and
# the branch: 32 heads at N = 203 are ineligible as they are (6.3 MB of bias);
# N = 449 is the first K5e N, 520 the shape tests/test_attention_kernel.py uses
_INELIGIBLE = {"n203": ((2, 32, 203, 8), False, "fused_attention_bwd_whole"),
               "n21": ((2, 3, 21, 8), True, "fused_attention_bwd_whole"),
               "n449": ((1, 2, 449, 8), True, "fused_attention_bwd_long"),
               "n520": ((1, 2, 520, 8), True, "fused_attention_bwd_long")}


@pytest.mark.parametrize("case", sorted(_INELIGIBLE))
def test_ineligible_branches_match_pallas_kernels(rng, monkeypatch, case):
    """K5b's plain version against ``_fwd_kernel`` and K5d's / K5e's against
    the VJP through ``_bwd_kernel`` / ``_bwd_block_merged_kernel`` (N padded
    to 256-row blocks there, not here), f32: each within 1e-5 of its own max
    abs; on CPU tensors the wrapper and autograd take exactly the plain
    version of the branch."""
    shape, patch, bwd = _INELIGIBLE[case]
    if patch:
        monkeypatch.setattr(jax_attention, "_HB_MAX_BIAS_BYTES", 0)
        monkeypatch.setattr(A, "_HB_MAX_BIAS_BYTES", 0)
    H, N = shape[1:3]
    assert A.fused_attention_route(H, N) == ("fused_attention_long", bwd)
    q, k, v, bias, do, scale = _operands(rng, shape)
    want = np.asarray(jax_attention.fused_attention(*(jnp.asarray(a) for a in (q, k, v, bias)),
                                                    scale, True))
    tq, tk, tv, tb, tdo = (torch.from_numpy(a) for a in (q, k, v, bias, do))
    got = A.fused_attention_long_reference(tq, tk, tv, tb, scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_TOL * np.abs(want).max())
    plain_bwd = getattr(A, bwd + "_reference")
    gwant = _jax_vjp(q, k, v, bias, do, scale)
    ggot = plain_bwd(tq, tk, tv, tb, tdo, scale)
    for name, g, w in zip(("dq", "dk", "dv", "db"), ggot, gwant):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=F32_TOL * np.abs(w).max(),
                                   err_msg=name)
    ts = [t.clone().requires_grad_() for t in (tq, tk, tv, tb)]
    out = A.fused_attention(*ts, scale)
    assert torch.equal(out, got)
    out.backward(tdo)
    for t, g in zip(ts, ggot):
        assert torch.equal(t.grad, g)


@pytest.mark.parametrize("kernel", ["K5b", "K5d", "K5e"])
def test_ineligible_branches_bf16_match_pallas_kernels(rng, monkeypatch, kernel):
    """bf16 operands, the head-blocked budget at 0 on both sides (and for
    K5e ``_WHOLE_BWD_MAX_N`` at 8, so N = 70 pads to one 256-row block in
    the reference): K5b's output within 1e-2 of the Pallas kernel's (p and o
    each rounded to bf16, |o| <= 2); K5d's / K5e's dq, dk, dv in bf16 within
    2e-2 of the kernel's max abs (both round p, ds and the outputs to bf16;
    K5e's reference also rounds each block's dk/dv partial, which the port
    does not) and db within 1e-2 relative L2 (bf16 products under f32 sums
    taken in another order), as test_torch_attention_long holds K3b."""
    for mod in (jax_attention, A):
        monkeypatch.setattr(mod, "_HB_MAX_BIAS_BYTES", 0)
        if kernel == "K5e":
            monkeypatch.setattr(mod, "_WHOLE_BWD_MAX_N", 8)
    q, k, v, bias, do, _ = _operands(rng, (2, 2, 70, 16))
    bf = lambda t: jnp.asarray(t).astype(jnp.bfloat16)  # noqa: E731
    tb16 = lambda t: torch.from_numpy(t).to(torch.bfloat16)  # noqa: E731
    if kernel == "K5b":
        want = np.asarray(jax_attention.fused_attention(bf(q), bf(k), bf(v), jnp.asarray(bias),
                                                        0.25, True).astype(jnp.float32))
        got = A.fused_attention(tb16(q), tb16(k), tb16(v), torch.from_numpy(bias), 0.25)
        assert got.dtype == torch.bfloat16
        assert np.abs(got.float().numpy() - want).max() <= 1e-2
        return
    name = "fused_attention_bwd_long" if kernel == "K5e" else "fused_attention_bwd_whole"
    assert A.fused_attention_route(2, 70)[1] == name
    _, vjp = jax.vjp(lambda q, k, v, b: jax_attention.fused_attention(q, k, v, b, 0.25, True),
                     bf(q), bf(k), bf(v), jnp.asarray(bias))
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(bf(do))]
    got = A.fused_attention_bwd(tb16(q), tb16(k), tb16(v), torch.from_numpy(bias), tb16(do), 0.25)
    for n, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16, n
        assert np.abs(g.float().numpy() - w).max() <= 2e-2 * np.abs(w).max(), n
    assert got[3].dtype == torch.float32
    assert np.linalg.norm(got[3].numpy() - want[3]) <= 1e-2 * np.linalg.norm(want[3])


def test_plain_versions_of_the_branches_are_one_function(rng):
    """K5b / K5d / K5e compute K5a / K5c's function in the same roundings
    (bf16 here): their plain versions agree bit for bit."""
    q, k, v, bias, do, scale = _operands(rng, (2, 3, 21, 8))
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    bias = torch.from_numpy(bias)
    assert torch.equal(A.fused_attention_long_reference(q, k, v, bias, scale),
                       A.fused_attention_reference(q, k, v, bias, scale))
    want = A.fused_attention_bwd_reference(q, k, v, bias, do, scale)
    for fn in (A.fused_attention_bwd_whole_reference, A.fused_attention_bwd_long_reference):
        for g, w in zip(fn(q, k, v, bias, do, scale), want):
            assert torch.equal(g, w)


def _flat_and_back(B, H, N, D):
    flat = lambda t: t.transpose(1, 2).reshape(B, N, H * D)  # noqa: E731
    back = lambda t: t.view(B, N, H, D).transpose(1, 2)  # noqa: E731
    return flat, back


@pytest.mark.parametrize("N,dtype", _SHORT_N)
def test_hopper_forward_order_matches_pallas_kernel(rng, N, dtype):
    """K5a launches K3f's wgmma kernel on head-major addressing (the same
    bits as K2f on transposed operands): K3f's one-pass order
    (test_torch_attention_long._one_pass) on the transposed operands, held
    against the reference's head-blocked Pallas kernel in interpret mode (B = 2, H = 2, D = 64) within the card's
    gates (chip_smoke.K2_BF16_TOL / K2_F32_TOL absolute)."""
    B, H, D = 2, 2, 64
    q, k, v, bias, _, scale = _operands(rng, (B, H, N, D))
    assert jax_attention._hb_eligible(H, N)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    want = jax_attention.fused_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                         jnp.asarray(bias), scale, True)
    flat, back = _flat_and_back(B, H, N, D)
    got = back(_one_pass(*(flat(torch.from_numpy(a).to(tdt)) for a in (q, k, v)),
                         torch.from_numpy(bias), scale)[0])
    assert got.dtype == tdt and got.shape == q.shape
    tol = K2_BF16_TOL if dtype == "bfloat16" else K2_F32_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("N,dtype", _SHORT_N)
def test_hopper_backward_order_matches_pallas_vjp(rng, N, dtype):
    """K5c launches K3b's kernels on head-major addressing: K3b's
    two-sided order (test_torch_attention_long._two_sided) on the transposed
    operands, held against ``jax.vjp`` of the reference's head-blocked Pallas
    kernel in interpret mode (B = 2, H = 2, D = 64) within the card's gates
    (chip_smoke.K2B_BF16_TOL / K2B_F32_TOL of each gradient's max abs, db
    chip_smoke.K2B_DB_REL relative L2)."""
    B, H, D = 2, 2, 64
    q, k, v, bias, do, scale = _operands(rng, (B, H, N, D))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    _, vjp = jax.vjp(lambda *a: jax_attention.fused_attention(*a, scale, True),
                     *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(bias))
    want = [np.asarray(w.astype(jnp.float32)) for w in vjp(jnp.asarray(do, jdt))]
    flat, back = _flat_and_back(B, H, N, D)
    tq, tk, tv, tdo = (flat(torch.from_numpy(a).to(tdt)) for a in (q, k, v, do))
    *got, _ = _two_sided(tq, tk, tv, torch.from_numpy(bias), tdo, scale)
    tol = K2B_BF16_TOL if dtype == "bfloat16" else K2B_F32_TOL
    for name, g, w in zip(("dq", "dk", "dv"), got[:3], want):
        g = back(g)
        assert g.dtype == tdt and tuple(g.shape) == w.shape, name
        assert np.abs(g.float().numpy() - w).max() <= tol * np.abs(w).max(), name
    assert np.linalg.norm(got[3].numpy() - want[3]) <= K2B_DB_REL * np.linalg.norm(want[3])
