"""The port's plain ``fused_attention_flat_long`` (K3f's plain version) and
its plain backward (K3b's) held against the JAX package's Pallas kernels in
interpret mode, and the rule that routes a sequence to K2f or K3f. f32
tolerance 1e-5: the same arithmetic, sums taken in another order."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import K2_BF16_TOL, K2B_BF16_TOL, K2B_DB_REL, K2B_F32_TOL
from mem_tpu.ops.attention import fused_attention_flat_long as jax_flat_long
from mem_tpu_torch.models import vit
from mem_tpu_torch.ops import attention as A

F32_TOL = 1e-5


def _operands(rng, B, N, H, D, ramp=False):
    """q, k, v (B, N, H*D) and bias (H, N, N), f32 numpy; ``ramp`` adds 0.1
    per key to the bias, so that a row's running max grows at every tile."""
    q, k, v = (rng.standard_normal((B, N, H * D)).astype(np.float32) for _ in range(3))
    bias = (0.1 * rng.standard_normal((H, N, N))).astype(np.float32)
    if ramp:
        bias = bias + np.float32(0.1) * np.arange(N, dtype=np.float32)
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


KERNEL_TILE = 64   # keys per tile of csrc/attention_long_fwd.cuh's wgmma kernel


def _one_pass(q, k, v, bias, scale, tile=KERNEL_TILE):
    """The order of arithmetic of K3f's wgmma kernel (bf16, head dim 64),
    emulated in torch: key tiles of the kernel's width; s = (q.k) * scale +
    bias in f32 with its two roundings; the running row max m, the row sum l
    and o rescaled by exp(m_old - m_new); p~ = exp(s - m) summed into l in
    f32 and rounded to v's dtype for p~ v (f32 accumulation); o / l rounded
    to q's dtype at the end. Returns (o, whether every row's max grew at every
    tile after the first)."""
    B, N, C = q.shape
    H = bias.shape[0]
    D = C // H
    qh, kh, vh = (t.float().view(B, N, H, D).transpose(1, 2) for t in (q, k, v))
    m = torch.full((B, H, N, 1), -torch.inf)
    l = torch.zeros(B, H, N, 1)
    o = torch.zeros(B, H, N, D)
    grew = True
    for j0 in range(0, N, tile):
        j1 = min(j0 + tile, N)
        s = (qh @ kh[:, :, j0:j1].transpose(-1, -2)) * scale + bias[:, :, j0:j1]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        grew = grew and (j0 == 0 or bool((m_new > m).all()))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.to(v.dtype).float() @ vh[:, :, j0:j1]
        m = m_new
    return (o * (1 / l)).to(q.dtype).transpose(1, 2).reshape(B, N, C), grew


@pytest.mark.parametrize("B,N,H,D,dtype,ramp", [
    (1, 130, 2, 64, "bfloat16", False),   # N ragged against the 64-key tile
    (2, 65, 2, 64, "bfloat16", False),    # one key past a tile
    (1, 300, 2, 64, "bfloat16", True),    # the max grows at every tile: the rescale runs
    (2, 300, 2, 64, "float32", True),
])
def test_flat_long_one_pass_order_matches_pallas_interpret(rng, B, N, H, D, dtype, ramp):
    """The wgmma kernel rounds the unnormalised p~ to bf16 where the
    reference rounds the normalised p: its order, emulated, held against the
    Pallas kernel in interpret mode on the same operands, within the card's
    gates (chip_smoke.K2_BF16_TOL, 2e-2 absolute, in bf16; 1e-5 in f32)."""
    check_one_pass_order(jax_flat_long, *_operands(rng, B, N, H, D, ramp), dtype, ramp)


def check_one_pass_order(jax_attn, q, k, v, bias, dtype, ramp):
    """``_one_pass`` on the operands in ``dtype`` against the Pallas kernel
    ``jax_attn`` (fused_attention_flat_long, or K2's fused_attention_flat) in
    interpret mode on the same operands, within K2_BF16_TOL in bf16 and
    F32_TOL in f32; with ``ramp`` every row's max must have grown at every
    tile."""
    B, N, C = q.shape
    scale = (C // bias.shape[0]) ** -0.5
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(jax.jit(lambda *a: jax_attn(*a, scale, True))(
        *(jnp.asarray(t).astype(jdt) for t in (q, k, v)), jnp.asarray(bias)).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got, grew = _one_pass(*(torch.from_numpy(t).to(tdt) for t in (q, k, v)),
                          torch.from_numpy(bias), scale)
    assert got.dtype == tdt and tuple(got.shape) == (B, N, C)
    assert grew or not ramp
    tol = K2_BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


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


def _two_sided(q, k, v, bias, do, scale, tile=KERNEL_TILE):
    """The order of arithmetic of K3b's wgmma kernels (bf16, head dim 64),
    emulated in torch. Rows side, per 64-key tile: pass A's s = (q.k) * scale
    + bias in f32 with its two roundings, dp = do.v in f32, the running row max
    m and the partial sums l = sum exp(s - m) and t = sum exp(s - m) dp, both
    rescaled by exp(m_old - m_new); delta = t / l. Pass B's per-tile p =
    exp(s - m) * (1 / l), ds = p (dp - delta) in f32, dq += ds (rounded to
    q's dtype) k. Columns side, per 64-row query tile: p and ds rebuilt from
    m, 1 / l and delta, dv += p (rounded) ^T do, dk += ds (rounded) ^T q. db =
    the sum of ds over the batch in batch order. dq and dk are scaled in f32
    and rounded once, dv rounded once. Returns (dq, dk, dv, db, whether pass A
    rescaled l and t at some tile after the first)."""
    B, N, C = q.shape
    H = bias.shape[0]
    D = C // H
    dt = q.dtype
    qh, kh, vh, doh = (t.float().view(B, N, H, D).transpose(1, 2) for t in (q, k, v, do))
    rnd = lambda x: x.to(dt).float()  # noqa: E731

    def tile_s(j0, j1):
        return (qh @ kh[:, :, j0:j1].transpose(-1, -2)) * scale + bias[:, :, j0:j1]

    m = torch.full((B, H, N, 1), -torch.inf)
    l = torch.zeros(B, H, N, 1)
    t = torch.zeros(B, H, N, 1)
    rescaled = False
    for j0 in range(0, N, tile):
        j1 = min(j0 + tile, N)
        s = tile_s(j0, j1)
        dp = doh @ vh[:, :, j0:j1].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        f = torch.exp(m - m_new)
        rescaled = rescaled or (j0 > 0 and bool((f < 1).any()))
        e = torch.exp(s - m_new)
        l = l * f + e.sum(-1, keepdim=True)
        t = t * f + (e * dp).sum(-1, keepdim=True)
        m = m_new
    delta, il = t / l, 1 / l
    dq = torch.zeros(B, H, N, D)
    ds_all = torch.zeros(B, H, N, N)
    for j0 in range(0, N, tile):
        j1 = min(j0 + tile, N)
        p = torch.exp(tile_s(j0, j1) - m) * il
        ds = p * (doh @ vh[:, :, j0:j1].transpose(-1, -2) - delta)
        ds_all[..., j0:j1] = ds
        dq = dq + rnd(ds) @ kh[:, :, j0:j1]
    dk = torch.zeros(B, H, N, D)
    dv = torch.zeros(B, H, N, D)
    for i0 in range(0, N, tile):
        i1 = min(i0 + tile, N)
        s = (qh[:, :, i0:i1] @ kh.transpose(-1, -2)) * scale + bias[:, i0:i1]
        p = torch.exp(s - m[:, :, i0:i1]) * il[:, :, i0:i1]
        dp = doh[:, :, i0:i1] @ vh.transpose(-1, -2)
        ds = p * (dp - delta[:, :, i0:i1])
        dv = dv + rnd(p).transpose(-1, -2) @ doh[:, :, i0:i1]
        dk = dk + rnd(ds).transpose(-1, -2) @ qh[:, :, i0:i1]
    db = torch.zeros(H, N, N)
    for bi in range(B):
        db = db + ds_all[bi]
    flat = lambda x: x.transpose(1, 2).reshape(B, N, C).to(dt)  # noqa: E731
    return flat(dq * scale), flat(dk * scale), flat(dv), db, rescaled


@pytest.mark.parametrize("B,N,dtype,ramp", [
    (2, 65, "bfloat16", False),    # one key and one query past a tile
    (2, 300, "bfloat16", True),    # ragged against the tile; the max grows at every tile
    (2, 65, "float32", False),
    (2, 300, "float32", True),
])
def test_flat_long_bwd_two_sided_order_matches_pallas_interpret(rng, B, N, dtype, ramp):
    """K3b's wgmma kernels go over the scores twice from the query side (an
    online pass for m, l and delta, then ds and dq) and once from the key
    side (dk, dv from the statistics): their order, emulated, held against
    ``jax.vjp`` of the Pallas kernel in interpret mode on the same operands
    (H = 2, D = 64) within the card's gates (chip_smoke.K2B_BF16_TOL /
    K2B_F32_TOL of each gradient's max abs, db chip_smoke.K2B_DB_REL relative
    L2), db also against the plain backward's, the comparison the card
    makes."""
    H, D = 2, 64
    operands = _operands(rng, B, N, H, D, ramp)
    do = rng.standard_normal((B, N, H * D)).astype(np.float32)
    check_two_sided_order(jax_flat_long, A.fused_attention_flat_long_bwd_reference, *operands, do,
                          dtype, ramp)


def check_two_sided_order(jax_attn, plain_bwd, q, k, v, bias, do, dtype, ramp):
    """``_two_sided`` on the operands in ``dtype`` against ``jax.vjp`` of the
    Pallas kernel ``jax_attn`` in interpret mode on the same operands, each
    gradient within K2B_BF16_TOL / K2B_F32_TOL of its max abs, db within
    K2B_DB_REL relative L2 of the vjp's and of the plain backward
    ``plain_bwd``'s; with ``ramp`` the rescale must have run."""
    scale = (q.shape[2] // bias.shape[0]) ** -0.5
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    _, vjp = jax.vjp(lambda q, k, v, b: jax_attn(q, k, v, b, scale, True),
                     *(jnp.asarray(t).astype(jdt) for t in (q, k, v)), jnp.asarray(bias))
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do).astype(jdt))]
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(t).to(tdt) for t in (q, k, v, do))
    tb = torch.from_numpy(bias)
    *got, rescaled = _two_sided(tq, tk, tv, tb, tdo, scale)
    assert rescaled or not ramp
    tol = K2B_BF16_TOL if dtype == "bfloat16" else K2B_F32_TOL
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt and tuple(g.shape) == w.shape, name
        assert np.abs(g.float().numpy() - w).max() <= tol * np.abs(w).max(), name
    db = got[3].numpy()
    plain_db = plain_bwd(tq, tk, tv, tb, tdo, scale)[3].numpy()
    for ref in (want[3], plain_db):
        assert np.linalg.norm(db - ref) <= K2B_DB_REL * np.linalg.norm(ref)


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
