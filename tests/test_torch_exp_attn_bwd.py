"""The paired attention backward X3 (mem_tpu_torch/ops/attention.py
``fused_attention_flat_bwd_pair``, driven by mem_tpu_torch/tools/exp_attn_bwd.py):
its plain version held against the reference's own Pallas body
(scripts/exp_attn_bwd.py:_bwd_flat_pair_kernel) run in interpret mode with
``run_bwd``'s block specs, on the same numpy inputs: f32 within 1e-5 of the
reference's max abs (the same math, sums in another order), bf16 within 2e-2
(bf16 roundings of p and ds from such sums); and against the port's plain K2b,
whose function it computes."""
import functools
import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mem_tpu_torch.ops import attention as A
from mem_tpu_torch.tools import exp_attn_bwd as T


def _import_reference(name):
    """Import a reference script from this checkout, undoing its
    process-wide edits (it points jax's compilation cache at a TPU directory
    and prepends a fixed path to sys.path). The reference package, then the
    scripts' shared module, then the script are each imported on this
    checkout's sys.path, restored after each, so every import a script makes
    resolves from sys.modules and the prepended path is never searched."""
    cache, path = jax.config.jax_compilation_cache_dir, list(sys.path)
    for module in ("mem_tpu.ops.attention", "scripts.trace_pretrain", name):
        try:
            importlib.import_module(module)
        finally:
            jax.config.update("jax_compilation_cache_dir", cache)
            sys.path[:] = path
    return sys.modules[name]


REF = _import_reference("scripts.exp_attn_bwd")


def _run_reference(q, k, v, bias, do, scale):
    """_bwd_flat_pair_kernel through ``pl.pallas_call`` as run_bwd builds it
    (exp_attn_bwd.py:92-116), in interpret mode."""
    B, N, C = q.shape
    H = bias.shape[0]
    spec = pl.BlockSpec((1, N, C), lambda b: (b, 0, 0), memory_space=pltpu.VMEM)
    bspec = pl.BlockSpec((H, N, N), lambda b: (0, 0, 0), memory_space=pltpu.VMEM)
    out = pl.pallas_call(
        functools.partial(REF._bwd_flat_pair_kernel, scale=scale, H=H, D=C // H),
        grid=(B,), in_specs=[spec, spec, spec, bspec, spec], out_specs=(spec, spec, spec, bspec),
        out_shape=(jax.ShapeDtypeStruct((B, N, C), q.dtype),) * 3
        + (jax.ShapeDtypeStruct((H, N, N), jnp.float32),),
        interpret=True)(q, k, v, bias, do)
    return [np.asarray(o.astype(jnp.float32)) for o in out]


def _operands(rng, B, N, H, D):
    q, k, v, do = (rng.standard_normal((B, N, H * D)).astype(np.float32) for _ in range(4))
    return q, k, v, (0.5 * rng.standard_normal((H, N, N))).astype(np.float32), do


def _rel_max_abs(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("B,N,H,D,dtype,tol", [
    (2, 24, 2, 8, "float32", 1e-5), (3, 13, 3, 4, "float32", 1e-5),
    (2, 24, 2, 8, "bfloat16", 2e-2)])
def test_pair_reference_matches_pallas_interpret(rng, B, N, H, D, dtype, tol):
    """Plain X3 == _bwd_flat_pair_kernel (interpret) in dq, dk, dv and the
    batch-summed db; the CPU wrapper takes the plain version."""
    ops = _operands(rng, B, N, H, D)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j = [jnp.asarray(a, jdt if i != 3 else jnp.float32) for i, a in enumerate(ops)]
    want = _run_reference(*j, D ** -0.5)
    t = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt if i != 3 else torch.float32)
         for i, a in enumerate(j)]
    got = A.fused_attention_flat_bwd_pair_reference(*t, D ** -0.5)
    for g, w, name in zip(got, want, ("dq", "dk", "dv", "db")):
        assert g.dtype == (tdt if name != "db" else torch.float32), name
        assert _rel_max_abs(g.float().numpy(), w) <= tol, name
    for g, w in zip(A.fused_attention_flat_bwd_pair(*t, D ** -0.5), got):
        assert torch.equal(g, w)


def test_plain_pair_equals_plain_k2b(rng):
    """The pair's zero blocks add nothing: its plain version equals K2b's to
    1e-6 of max abs in f32 (the products' sums are only regrouped)."""
    t = [torch.from_numpy(a) for a in _operands(rng, 3, 37, 4, 16)]
    for g, w in zip(A.fused_attention_flat_bwd_pair_reference(*t, 0.25),
                    A.fused_attention_flat_bwd_reference(*t, 0.25)):
        assert _rel_max_abs(g.numpy(), w.numpy()) <= 1e-6


def test_pair_non_cuda_device_raises():
    """A tensor on neither the CPU nor a CUDA device never reaches the plain
    version or the kernel."""
    q = torch.zeros(2, 8, 16, dtype=torch.bfloat16, device="meta")
    bias = torch.zeros(2, 8, 8, device="meta")
    with pytest.raises(ValueError):
        A.fused_attention_flat_bwd_pair(q, q, q, bias, q, 0.25)


def test_main_exits_nonzero_without_a_card(monkeypatch, capsys):
    """The experiment runs on the card only: without one it says so and
    returns 2, printing no timing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert T.main(["B=2", "steps=1"]) == 2
    out = capsys.readouterr()
    assert "no CUDA device" in out.err and "bwd:" not in out.out


def test_bound_at_the_experiment_shape():
    """The H100 bound the tool prints at the reference's shape (ViT-B
    training, B = 128): 274,848,096 bytes (q, k, v, do read and dq, dk, dv
    written in bf16, the f32 bias read and db written) over 3.35 TB/s, above
    the five products' 38.15 GFLOP over 989 TFLOP/s."""
    from mem_tpu_torch.tools import attention_bwd_bound, attention_bwd_work

    assert attention_bwd_work(128, 197, 12, 64) == (274_848_096, 38_150_799_360)
    ms, by = attention_bwd_bound(128, 197, 12, 64)
    assert by == "bytes" and ms == pytest.approx(274_848_096 / 3.35e9)
