"""The fused MLP of the port (ops/mlp.py, kernels K6f/K6b) held against the
Pallas kernels of mem_tpu/ops/mlp.py in interpret mode, as
tests/test_mlp_fused.py runs them: the plain versions (what the CPU path
and the card comparisons use) against the kernels' forward, residual and
all five gradients, the erf polynomial, and the Mlp module under
``FUSED_MLP`` on both sides."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mem_tpu.models.vit as jax_vit
from mem_tpu.ops import mlp as jax_mlp
from mem_tpu_torch.models import vit as tvit
from mem_tpu_torch.ops import mlp as tmlp

C, HD = 128, 256
_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _operands(rng, rows):
    return dict(x=rng.standard_normal((rows, C)).astype(np.float32),
                w1=(rng.standard_normal((C, HD)) * 0.05).astype(np.float32),
                b1=(rng.standard_normal((HD,)) * 0.05).astype(np.float32),
                w2=(rng.standard_normal((HD, C)) * 0.05).astype(np.float32),
                b2=(rng.standard_normal((C,)) * 0.05).astype(np.float32))


def _t(a, dt):
    return torch.from_numpy(np.array(a, np.float32)).to(dt)


def _np(a):
    return np.asarray(a.astype(jnp.float32)) if isinstance(a, jax.Array) \
        else a.detach().float().numpy()


def test_erf_polynomial_within_2e_7_of_erf_and_equal_to_the_reference(rng):
    """Abramowitz & Stegun 7.1.26: |error| < 1.5e-7 in exact arithmetic
    (checked in f64), and in f32 the port's and the reference's evaluations
    agree to f32 rounding."""
    x = np.concatenate([np.linspace(-6, 6, 4001), rng.standard_normal(2000), [0.0]])
    got = tmlp.erf_poly(torch.from_numpy(x))
    assert float((got - torch.erf(torch.from_numpy(x))).abs().max()) < 2e-7
    x32 = x.astype(np.float32)
    np.testing.assert_allclose(tmlp.erf_poly(torch.from_numpy(x32)).numpy(),
                               np.asarray(jax_mlp._erf_poly(jnp.asarray(x32))), atol=3e-7)
    np.testing.assert_allclose(tmlp.gelu_poly(torch.from_numpy(x32)).numpy(),
                               np.asarray(jax_mlp._gelu_kernel(jnp.asarray(x32))), atol=1e-6)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("save_h", [True, False])
@pytest.mark.parametrize("rows", [8, 600])   # below and above the TPU row tile (its pad path)
def test_forward_matches_pallas_kernel(rng, rows, save_h, dt):
    """K6f's plain version against ``_mlp_fwd_2d`` (interpret): out and the h
    residual. f32: atol 2e-5 (tests/test_mlp_fused.py's limit). bf16: both
    sides round h, g and out to bf16 at the same places, so they differ by a
    bf16 ulp where an f32 sum lands on a rounding boundary: 2e-2."""
    ops = _operands(rng, rows)
    want, want_h = jax_mlp._mlp_fwd_2d(*(jnp.asarray(ops[k], _JDT[dt]) for k in
                                         ("x", "w1", "b1", "w2", "b2")),
                                       interpret=True, save_h=save_h)
    got, got_h = tmlp.mlp_fwd_2d(*(_t(ops[k], _TDT[dt]) for k in
                                   ("x", "w1", "b1", "w2", "b2")), save_h=save_h)
    atol = 2e-5 if dt == "f32" else 2e-2
    assert got.dtype == _TDT[dt] and got.shape == (rows, C)
    np.testing.assert_allclose(_np(got), _np(want), atol=atol)
    if save_h:
        np.testing.assert_allclose(_np(got_h), _np(want_h), atol=atol)
    else:
        assert got_h is None and want_h is None


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("rows", [8, 600])
def test_backward_matches_pallas_kernel(rng, rows, dt):
    """K6b's plain version against ``_mlp_bwd_2d`` (interpret) from the same
    (do, h, x, W1, W2): dx, dW1, dW2, db1, db2; the last four f32. f32: 5e-4
    (tests/test_mlp_fused.py's limit for the gradients). bf16: 2e-2 of each
    gradient's largest value (one bf16 rounding of g or dh, summed over the
    rows)."""
    ops = _operands(rng, rows)
    do = rng.standard_normal((rows, C)).astype(np.float32)
    h = (rng.standard_normal((rows, HD)) * 1.5).astype(np.float32)
    j = lambda a: jnp.asarray(a, _JDT[dt])
    want = jax_mlp._mlp_bwd_2d(j(do), j(h), j(ops["x"]), j(ops["w1"]), j(ops["w2"]),
                               interpret=True)
    t = lambda a: _t(a, _TDT[dt])
    got = tmlp.mlp_bwd_2d(t(do), t(h), t(ops["x"]), t(ops["w1"]), t(ops["w2"]))
    assert got[0].dtype == _TDT[dt] and all(g.dtype == torch.float32 for g in got[1:])
    for g, w, name in zip(got, want, ("dx", "dW1", "dW2", "db1", "db2")):
        w = _np(w)
        assert tuple(g.shape) == w.shape, name
        tol = 5e-4 if dt == "f32" else 2e-2 * np.abs(w).max()
        np.testing.assert_allclose(_np(g), w, atol=tol, rtol=5e-4 if dt == "f32" else 0,
                                   err_msg=name)


@pytest.mark.parametrize("rows", [8, 600])
def test_autograd_function_matches_custom_vjp(rng, rows):
    """``mlp_fused`` end to end, f32 parameters and a (2, rows/2, C) input,
    against ``jax.grad`` through the reference's custom VJP: the loss and
    all five gradients (tests/test_mlp_fused.py's 2e-5 / 5e-4)."""
    ops = _operands(rng, rows)
    keys = ("x", "w1", "b1", "w2", "b2")
    jargs = [jnp.asarray(ops[k]) for k in keys]
    jargs[0] = jargs[0].reshape(2, rows // 2, C)
    want_out = jax.jit(lambda *a: jax_mlp.mlp_fused(*a, True))(*jargs)
    want = jax.jit(jax.grad(lambda *a: jnp.sum(jax_mlp.mlp_fused(*a, True) ** 2),
                            argnums=(0, 1, 2, 3, 4)))(*jargs)
    targs = [torch.from_numpy(ops[k]).requires_grad_() for k in keys]
    out = tmlp.mlp_fused(targs[0].reshape(2, rows // 2, C), *targs[1:])
    np.testing.assert_allclose(_np(out), _np(want_out), atol=2e-5)
    (out ** 2).sum().backward()
    for a, w, name in zip(targs, want, keys):
        np.testing.assert_allclose(a.grad.numpy().reshape(w.shape), _np(w), atol=5e-4,
                                   rtol=5e-4, err_msg=name)


def test_inference_call_stores_no_residual(rng, monkeypatch):
    """Where nothing requires a gradient the wrapper takes the
    ``save_h=False`` form, as the reference's primal does (mlp.py:207-211)."""
    seen = []
    real = tmlp.mlp_fwd_2d
    monkeypatch.setattr(tmlp, "mlp_fwd_2d",
                        lambda *a, save_h=True: seen.append(save_h) or real(*a, save_h=save_h))
    ops = _operands(rng, 8)
    args = [torch.from_numpy(ops[k]) for k in ("x", "w1", "b1", "w2", "b2")]
    tmlp.mlp_fused(*args)
    args[1].requires_grad_()
    tmlp.mlp_fused(*args)
    assert seen == [False, True]


def test_parameters_arrive_f32_and_gradients_leave_f32(rng):
    ops = _operands(rng, 8)
    x = torch.from_numpy(ops["x"]).bfloat16().requires_grad_()
    params = [torch.from_numpy(ops[k]).requires_grad_() for k in ("w1", "b1", "w2", "b2")]
    out = tmlp.mlp_fused(x, *params)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16
    assert all(p.grad.dtype == torch.float32 and p.grad.shape == p.shape for p in params)


def test_wrappers_never_take_the_plain_version_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel's checks and
    raises where no kernel can run; it never reaches the plain version."""
    m = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tmlp.mlp_fwd_2d(m(4, C), m(C, HD), m(HD), m(HD, C), m(C))
    with pytest.raises(ValueError, match="CUDA device"):
        tmlp.mlp_bwd_2d(m(4, C), m(4, HD), m(4, C), m(C, HD), m(HD, C))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mlp_module_under_fused_mlp_matches_flax(rng, monkeypatch, dt):
    """The Mlp module with ``FUSED_MLP`` on both sides (``mlp.FORCE`` sends
    the flax module through the Pallas kernels on the CPU, as
    tests/test_mlp_fused.py:45-63): output and parameter gradients; and the
    port's fused path against its own unfused one."""
    monkeypatch.setattr(jax_vit, "FUSED_MLP", True)
    monkeypatch.setattr(jax_mlp, "FORCE", True)
    fm = jax_vit.Mlp(hidden_dim=64, out_dim=32, dtype=_JDT[dt])
    x = rng.standard_normal((3, 7, 32)).astype(np.float32)
    params = jax.tree.map(lambda a: jnp.asarray(0.2 * rng.standard_normal(a.shape), jnp.float32),
                          fm.init(jax.random.key(0), jnp.asarray(x)))
    xj = jnp.asarray(x, _JDT[dt])
    want = fm.apply(params, xj)
    gwant = jax.grad(lambda p: jnp.sum(fm.apply(p, xj).astype(jnp.float32) ** 2))(params)["params"]

    tm = tvit.Mlp(32, 64, dtype=_TDT[dt])
    with torch.no_grad():
        for fc in ("fc1", "fc2"):
            getattr(tm, fc).weight.copy_(_t(params["params"][fc]["kernel"], torch.float32).t())
            getattr(tm, fc).bias.copy_(_t(params["params"][fc]["bias"], torch.float32))
    xt = _t(x, _TDT[dt])
    plain = tm(xt)
    monkeypatch.setattr(tvit, "FUSED_MLP", True)
    got = tm(xt)
    tol = 2e-5 if dt == "f32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), atol=tol)
    np.testing.assert_allclose(_np(got), _np(plain), atol=tol)
    (got.float() ** 2).sum().backward()
    for fc in ("fc1", "fc2"):
        gw, gb = _np(gwant[fc]["kernel"]), _np(gwant[fc]["bias"])
        gtol = 5e-4 if dt == "f32" else 2e-2 * np.abs(gw).max()
        np.testing.assert_allclose(getattr(tm, fc).weight.grad.numpy().T, gw, atol=gtol)
        np.testing.assert_allclose(getattr(tm, fc).bias.grad.numpy(), gb,
                                   atol=5e-4 if dt == "f32" else 2e-2 * np.abs(gb).max())


def test_fused_mlp_toggle_is_off_by_default_and_yields_to_dropout(rng, monkeypatch):
    assert tvit.FUSED_MLP is False and jax_vit.FUSED_MLP is False
    calls = []
    monkeypatch.setattr(tvit, "mlp_fused", lambda *a: calls.append(1) or a[0])
    tm = tvit.Mlp(32, 64, dropout=0.1).eval()
    x = torch.from_numpy(rng.standard_normal((2, 5, 32)).astype(np.float32))
    tm(x)
    monkeypatch.setattr(tvit, "FUSED_MLP", True)
    tm(x)                       # dropout > 0 keeps the unfused path (vit.py:269)
    assert calls == []
    tvit.Mlp(32, 64)(x)
    assert calls == [1]
