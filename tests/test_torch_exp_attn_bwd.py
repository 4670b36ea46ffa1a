"""The paired attention backward X3 (mem_tpu_torch/ops/attention.py
``fused_attention_flat_bwd_pair``, driven by mem_tpu_torch/tools/exp_attn_bwd.py):
its plain version held against the reference's own Pallas body
(scripts/exp_attn_bwd.py:_bwd_flat_pair_kernel) run in interpret mode with
``run_bwd``'s block specs, on the same numpy inputs: f32 within 1e-5 of the
reference's max abs (the same math, sums in another order), bf16 within 2e-2
(bf16 roundings of p and ds from such sums); and against the port's plain K2b,
whose function it computes. The tool's base is K2b (the reference's
``_bwd_flat_kernel``); its executed-work figures; the wrapper's rules."""
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


def test_main_runs_k2b_beside_the_pair(monkeypatch, capsys):
    """The tool's base is K2b (``fused_attention_flat_bwd``, the reference's
    ``_bwd_flat_kernel``) and its pair X3: main, with both wrappers spied on
    their plain versions and the card's timers replaced by plain calls, calls
    each once for the check, 1 + steps times in each of two timed turns and
    3 + steps times in each of two device-time profiles (its three kernels,
    the rows kernel alone), and nothing else; the pair agrees with the base
    and main returns 0."""
    calls = []

    def spy(name, plain):
        def fn(*args):
            calls.append(name)
            return plain(*args)
        return fn

    def time_ms(fn, runs, warmup):
        for _ in range(warmup + runs):
            fn()
        return 1.0

    def device_ms(fn, fragments, n):
        for _ in range(3 + n):
            fn()
        return 0.25

    import mem_tpu_torch.utils.env as env

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(env, "nvidia_smi", lambda: "no card")
    make = T.make_operands
    monkeypatch.setattr(T, "make_operands", lambda B, N, H, D, device: make(B, N, H, D, "cpu"))
    monkeypatch.setattr(T, "time_ms", time_ms)
    monkeypatch.setattr(T, "device_ms", device_ms)
    monkeypatch.setattr(T, "fused_attention_flat_bwd", spy(
        "fused_attention_flat_bwd", A.fused_attention_flat_bwd_reference))
    monkeypatch.setattr(T, "fused_attention_flat_bwd_pair", spy(
        "fused_attention_flat_bwd_pair", A.fused_attention_flat_bwd_pair_reference))
    steps = 2
    assert T.main(["B=2", "N=13", "H=2", "D=8", f"steps={steps}"]) == 0
    per_fn = 1 + 2 * (1 + steps) + 2 * (3 + steps)
    assert {n: calls.count(n) for n in set(calls)} == {
        "fused_attention_flat_bwd": per_fn, "fused_attention_flat_bwd_pair": per_fn}
    out = capsys.readouterr().out
    assert "base bwd:" in out and "pair bwd:" in out and "pair / base:" in out


def test_executed_work_at_the_experiment_shape():
    """The executed GFLOP the tool prints beside the bound at (128, 197, 12,
    64), 7.630 GFLOP per N^2 D of multiply-adds: the five products 38.15 (the
    bound's operations), K2b's Hopper body 68.67 (9 units), X3 99.19 (13: the
    pair doubles the rows kernel's two score products in both passes)."""
    from mem_tpu_torch.tools import attention_bwd_work

    shape = (128, 197, 12, 64)
    assert T.executed_gflop(*shape, "products") * 1e9 == pytest.approx(
        attention_bwd_work(*shape)[1], rel=1e-12)
    assert [round(T.executed_gflop(*shape, body), 2) for body in ("products", "base", "pair")] \
        == [38.15, 68.67, 99.19]


def test_cpu_wrapper_is_the_plain_pair_in_bf16_at_a_straddling_n(rng):
    """On the CPU the wrapper returns the plain pair's bits, bf16 at N = 37
    (a 64-row tile's ragged edge on the card)."""
    t = [torch.from_numpy(a).to(torch.bfloat16 if i != 3 else torch.float32)
         for i, a in enumerate(_operands(rng, 2, 37, 3, 64))]
    got = A.fused_attention_flat_bwd_pair(*t, 0.125)
    want = A.fused_attention_flat_bwd_pair_reference(*t, 0.125)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype,D,N,offset", [
    ("float32", 64, 197, 0), ("bfloat16", 32, 197, 0), ("bfloat16", 64, 257, 0),
    ("bfloat16", 64, 197, 1)])
def test_pair_rules_raise_before_a_launch(monkeypatch, dtype, D, N, offset):
    """X3 takes K2b's Hopper domain only: bf16 at head dim 64, N <= FLAT_MAX_N,
    16-byte aligned operands; anything else raises before the kernel library
    is touched (operands on the meta device past the device check)."""
    from mem_tpu_torch.kernels import build

    def no_library(*args):
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(build, "library", no_library)
    monkeypatch.setattr(A, "_check_cuda_operands", lambda name, tensors, q, bias: (1, N, 2, D))
    q = torch.zeros(N * 2 * D + offset, dtype=getattr(torch, dtype), device="meta")
    q = q[offset:].view(1, N, 2 * D)
    bias = torch.zeros(2, N, N, device="meta")
    with pytest.raises(ValueError):
        A.fused_attention_flat_bwd_pair(q, q, q, bias, q, 0.125)
