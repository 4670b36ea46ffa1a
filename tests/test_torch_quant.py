"""W8A8 int8 serving on the port (mem_tpu_torch/ops/quant.py and
``models.vit.INT8_GEMM``) held against the JAX package's
(mem_tpu/ops/quant.py, tests/test_quant.py) on the same numpy inputs.

- The four functions: int8 tensors and scales exact, outputs within one ulp
  of the output dtype (f32 and bf16 inputs, zero rows and columns, leading
  dims); the plain int8 product exact; the whole (C, 3C) qkv product equal
  to its three slices'.
- Tiny ``ft_vit`` eval forwards with the flag on, flax vs port, on the flat,
  the einsum and the head-major route, under ``FUSED_MLP``, and a tiny
  segmentor: f32 logits within 1e-4 relative L2. Both sides quantize the
  same f32 activations, but those differ by summation order at ~1e-7, which
  can move a value across a rounding boundary of its int8 step: 1.4e-5 is
  the largest seen over four seeds, every other case reads <= 3.2e-7. The
  int8 forward itself is 3.7e-4 to 4.1e-3 away from the f32 one, so the
  gate tells the two apart; the int8 products are counted on every route.
- Training forwards ignore the flag; the flag is the reference's default.
- ``serve --int8 1`` on the CPU (``test_seg --int8 1`` is in
  tests/test_torch_seg_cli.py, ``run_class_finetuning --int8 1 --eval`` in
  tests/test_torch_finetune.py, beside their fixtures).
"""
import contextlib
import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mem_tpu.ops.attention as jax_attention
import mem_tpu.ops.mlp as jax_mlp
from mem_tpu.models import vit as jax_vit
from mem_tpu.ops import quant as jq
from mem_tpu_torch.models import vit as tvit
from mem_tpu_torch.ops import quant as tq

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_finetune import _pair  # noqa: E402

LOGITS_REL = 1e-4
_SEG_BACKBONE = dict(img_size=64, embed_dim=32, depth=2, num_heads=2, out_indices=(0, 0, 0, 1))
_DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(rng, shape, dt):
    x = rng.standard_normal(shape).astype(np.float32) * rng.uniform(0.1, 4.0)
    x[..., 1, :] = 0.0                       # a zero row: its scale is 1.0
    jx = jnp.asarray(x, _DT[dt][0])
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(_DT[dt][1])


def _weight(rng, C_in, C_out):
    w = rng.standard_normal((C_in, C_out)).astype(np.float32) * 0.05
    w[:, 2] = 0.0                            # a zero column (a fresh zero-init head)
    return w


def _within_one_ulp(got, want, dt):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = np.spacing(np.abs(want)) * (2.0 ** 16 if dt == "bf16" else 1.0)
    assert np.all(np.abs(got - want) <= ulp), np.abs(got - want).max()


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(40, 64), (2, 5, 64), (3, 2, 7, 32)])
def test_quantize_activation_exact(rng, dt, shape):
    jx, tx = _inputs(rng, shape, dt)
    jq8, js = jq.quantize_activation(jx)
    tq8, ts = tq.quantize_activation(tx)
    assert tq8.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == shape[:-1] + (1,)
    np.testing.assert_array_equal(tq8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert np.all(ts.numpy()[..., 1, :] == 1.0)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_quantize_weight_exact(rng, dt):
    w = _weight(rng, 96, 40)
    jw = jnp.asarray(w, _DT[dt][0])
    tw = torch.from_numpy(np.asarray(jw.astype(jnp.float32))).to(_DT[dt][1])
    jq8, js = jq.quantize_weight(jw)
    tq8, ts = tq.quantize_weight(tw)
    np.testing.assert_array_equal(tq8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[2] == 1.0 and not tq8[:, 2].any()


def test_quantize_weight_keeps_the_transposed_layout(rng):
    """The models pass ``nn.Linear.weight.t()``: the int8 weight stays its
    transposed view, the column-major operand the CUDA product reads."""
    w = torch.from_numpy(_weight(rng, 64, 48)).t().contiguous()      # (out, in)
    wq, _ = tq.quantize_weight(w.t())
    assert wq.shape == (64, 48) and wq.stride() == (1, 64)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(40, 64), (2, 5, 64)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_dense_w8a8_matches_jax(rng, dt, shape, with_bias):
    jx, tx = _inputs(rng, shape, dt)
    w = _weight(rng, shape[-1], 24)
    b = rng.standard_normal(24).astype(np.float32) if with_bias else None
    want = jq.dense_w8a8(jx, jnp.asarray(w), None if b is None else jnp.asarray(b))
    got = tq.dense_w8a8(tx, torch.from_numpy(w), None if b is None else torch.from_numpy(b))
    assert got.dtype == tx.dtype and tuple(got.shape) == shape[:-1] + (24,)
    _within_one_ulp(_np(got), want, dt)
    # an explicit output dtype
    want32 = jq.dense_w8a8(jx, jnp.asarray(w), out_dtype=jnp.float32)
    _within_one_ulp(tq.dense_w8a8(tx, torch.from_numpy(w), out_dtype=torch.float32).numpy(),
                    want32, "f32")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_dense_w8a8_prequant_matches_jax(rng, dt):
    jx, tx = _inputs(rng, (3, 9, 64), dt)
    w, b = _weight(rng, 64, 32), rng.standard_normal(32).astype(np.float32)
    jxq, jrs = jq.quantize_activation(jx)
    txq, trs = tq.quantize_activation(tx)
    for bias in (None, b):
        want = jq.dense_w8a8_prequant(jxq, jrs, jnp.asarray(w),
                                      None if bias is None else jnp.asarray(bias), _DT[dt][0])
        got = tq.dense_w8a8_prequant(txq, trs, torch.from_numpy(w),
                                     None if bias is None else torch.from_numpy(bias),
                                     _DT[dt][1])
        _within_one_ulp(_np(got), want, dt)


def test_one_qkv_product_equals_three_slices(rng):
    """The port's qkv is one int8 product over the whole (C, 3C) weight, the
    reference's three against its slices: the weight scales are per output
    column, so the int32 accumulators and the outputs are equal."""
    x = torch.from_numpy(rng.standard_normal((2, 7, 32)).astype(np.float32))
    w = torch.from_numpy(_weight(rng, 32, 96))
    xq, rs = tq.quantize_activation(x)
    whole = tq.dense_w8a8_prequant(xq, rs, w, None, torch.float32)
    slices = torch.cat([tq.dense_w8a8_prequant(xq, rs, w[:, i:i + 32], None, torch.float32)
                        for i in (0, 32, 64)], dim=-1)
    assert torch.equal(whole, slices)
    wq, _ = tq.quantize_weight(w)
    acc = tq.int8_matmul(xq.reshape(-1, 32), wq)
    assert torch.equal(acc[:, 32:64], tq.int8_matmul(xq.reshape(-1, 32),
                                                     tq.quantize_weight(w[:, 32:64])[0]))


@pytest.mark.parametrize("K", [8, 768, 3072])
def test_int8_matmul_plain_is_exact(rng, K):
    a = rng.integers(-127, 128, (20, K)).astype(np.int8)
    b = rng.integers(-127, 128, (K, 16)).astype(np.int8)
    a[0], b[:, 0] = 127, -127                  # the extreme sum, -127^2 * K
    got = tq.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))
    assert got[0, 0] == -127 * 127 * K


def test_int8_matmul_refuses_bad_operands():
    a, b = torch.zeros(20, 16, dtype=torch.int8), torch.zeros(16, 8, dtype=torch.int8)
    for x, y in ((a.float(), b), (a, b[:8]), (a[None], b)):
        with pytest.raises(ValueError, match="int8_matmul"):
            tq.int8_matmul(x, y)
    with pytest.raises(ValueError, match="operands on"):
        tq.int8_matmul(a, b.to("meta"))


# -- the model with the flag on ----------------------------------------------

def test_flag_default_is_the_reference_s():
    assert tvit.INT8_GEMM is False and jax_vit.INT8_GEMM is False


@contextlib.contextmanager
def _int8_products(monkeypatch):
    """Counts the port's int8 products (the plain version on the CPU)."""
    calls = []
    real = tq.int8_matmul_reference

    def spy(a, b):
        calls.append(tuple(a.shape) + (b.shape[1],))
        return real(a, b)

    monkeypatch.setattr(tq, "int8_matmul_reference", spy)
    yield calls
    monkeypatch.setattr(tq, "int8_matmul_reference", real)


def _routes(mp, route, fused_mlp=False):
    """Both packages on one route: "flat" (K2f), "einsum" (the port's
    ``fused=False``; flax off its kernels on the CPU) or "bhnd" (K5a,
    ``FLAT_ATTN = False``)."""
    mp.setattr(jax_attention, "ENABLED", route != "einsum")
    for mod in (jax_vit, tvit):
        mp.setattr(mod, "FLAT_ATTN", route != "bhnd")
        mp.setattr(mod, "FUSED_MLP", fused_mlp)
        mp.setattr(mod, "INT8_GEMM", True)
    mp.setattr(jax_mlp, "FORCE", fused_mlp)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("route,fused_mlp,products", [
    ("flat", False, 3), ("einsum", False, 3), ("bhnd", False, 1), ("flat", True, 2),
    ("bhnd", True, 0)], ids=["flat", "einsum", "bhnd", "flat_fused_mlp", "bhnd_fused_mlp"])
def test_ft_vit_int8_eval_matches_flax(rng, monkeypatch, route, fused_mlp, products):
    """The flat and einsum routes quantize qkv, proj and fc1 (3 products a
    block), the head-major route only fc1 (the reference has no int8 branch
    there), and ``FUSED_MLP`` keeps the MLP on its kernel (vit.py:268-270)."""
    _routes(monkeypatch, route, fused_mlp)
    fmodel, variables, tmodel = _pair(rng)
    for blk in tmodel.blocks:
        blk.attn.fused = route != "einsum"
    x = rng.random((3, 32, 32, 3)).astype(np.float32)
    want = np.asarray(fmodel.apply(variables, jnp.asarray(x)))
    with _int8_products(monkeypatch) as calls, torch.no_grad():
        got = tmodel.eval()(torch.from_numpy(x)).numpy()
    assert len(calls) == products * len(tmodel.blocks), calls
    assert _rel(got, want) <= LOGITS_REL, _rel(got, want)
    monkeypatch.setattr(jax_vit, "INT8_GEMM", False)
    f32 = np.asarray(fmodel.apply(variables, jnp.asarray(x)))
    if products:                       # the gate tells int8 from the f32 forward
        assert _rel(want, f32) > 3 * LOGITS_REL


def test_int8_ignored_on_training_forward(rng, monkeypatch):
    """A training-mode forward is bit-identical with the flag on and off, and
    runs no int8 product (tests/test_quant.py:98-115)."""
    from mem_tpu_torch.models.registry import create_model

    model = create_model("ft_vit", num_classes=5, img_size=(32, 32), patch_size=(8, 8),
                         embed_dim=32, depth=2, num_heads=2, drop_rate=0.1,
                         drop_path_rate=0.1).train()
    x = torch.from_numpy(rng.random((2, 32, 32, 3)).astype(np.float32))
    outs = []
    for on in (True, False):
        monkeypatch.setattr(tvit, "INT8_GEMM", on)
        with _int8_products(monkeypatch) as calls, torch.no_grad():
            outs.append(model(x, generator=torch.Generator().manual_seed(7)))
        assert not calls
    assert torch.equal(*outs)


def test_int8_gemm_context_restores_the_flag():
    with tvit.int8_gemm():
        assert tvit.INT8_GEMM is True
        with tvit.int8_gemm(False):
            assert tvit.INT8_GEMM is True
    assert tvit.INT8_GEMM is False


# -- the segmentor ------------------------------------------------------------

@pytest.fixture(scope="module")
def seg_pair():
    from mem_tpu.models import segmentation as jseg
    from mem_tpu_torch.models import segmentation as tseg
    from mem_tpu_torch.utils.weights import seg_from_jax_params

    rng = np.random.default_rng(3)
    cfg = _SEG_BACKBONE
    fmodel = jseg.EncoderDecoder(num_classes=3, backbone_cfg=dict(cfg), dtype=jnp.float32,
                                 head_channels=16, aux_channels=8)
    variables = jax.jit(functools.partial(fmodel.init, train=False))(
        jax.random.key(0), jnp.zeros((1, 44, 64, 3)))

    def redraw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            return np.asarray(leaf)
        if "'var'" in name:
            return np.asarray(0.5 + rng.random(leaf.shape), np.float32)
        base = 1.0 if "scale" in name else 0.0
        return np.asarray(base + 0.2 * rng.standard_normal(leaf.shape), np.float32)

    variables = jax.tree_util.tree_map_with_path(redraw, jax.device_get(variables))
    tmodel = tseg.EncoderDecoder(num_classes=3, backbone_cfg=dict(cfg), dtype=torch.float32,
                                 head_channels=16, aux_channels=8)
    tmodel.load_state_dict(seg_from_jax_params(variables), strict=True)
    return fmodel, variables, tmodel.eval()


def test_seg_int8_forward_matches_flax(seg_pair, rng, monkeypatch):
    """The segmentor with the flag on (flax on its CPU einsum path, the port
    on the flat one: both quantize qkv, proj and fc1): the logits within
    1e-4, and the backbone's last tap within 1/20 of the int8 forward's own
    distance from the f32 one (2.8e-7 against 8.5e-5 here: the patch
    embedding dominates this redrawn trunk, so that distance is small)."""
    from mem_tpu.models import segmentation as jseg

    fmodel, variables, tmodel = seg_pair
    for mod in (jax_vit, tvit):
        monkeypatch.setattr(mod, "INT8_GEMM", True)
    x = rng.random((2, 44, 64, 3)).astype(np.float32)
    fb = jseg.EvBEiT(dtype=jnp.float32, **_SEG_BACKBONE)
    backbone = {"params": variables["params"]["backbone"],
                "batch_stats": variables["batch_stats"]["backbone"]}
    jfeat = lambda: np.asarray(fb.apply(backbone, jnp.asarray(x), False)[-1])  # noqa: E731
    want = np.asarray(fmodel.apply(variables, jnp.asarray(x), train=False)[0])
    want_tap = jfeat()
    with _int8_products(monkeypatch) as calls, torch.inference_mode():
        got = tmodel(torch.from_numpy(x))[0].numpy()
        got_tap = tmodel.backbone(torch.from_numpy(x))[-1].numpy()
    assert len(calls) == 2 * 3 * 2
    assert _rel(got, want) <= LOGITS_REL, _rel(got, want)
    monkeypatch.setattr(jax_vit, "INT8_GEMM", False)
    gap = _rel(want_tap, jfeat())
    assert _rel(got_tap, want_tap) <= 0.05 * gap, (_rel(got_tap, want_tap), gap)


# -- the CLIs on the CPU ------------------------------------------------------

@pytest.fixture(scope="module")
def serve_checkpoints(tmp_path_factory):
    """tests/test_torch_serve.py's ft_vit: an orbax checkpoint for the
    reference's server and the same weights as a .pth for the port's."""
    import test_torch_serve as S
    from mem_tpu.cli.run_class_finetuning import _build_ft_vit
    from mem_tpu.cli.serve import get_args
    from mem_tpu.utils.checkpoint import save_checkpoint
    from mem_tpu.utils.torch_import import export_vit_params

    out = tmp_path_factory.mktemp("serve_int8")
    jax_dir, pth_dir = out / "orbax", out / "pth"
    pth_dir.mkdir()
    model = _build_ft_vit(get_args(["--checkpoint", str(jax_dir)] + S._MODEL_FLAGS), 4, 16,
                          jnp.float32)
    variables = jax.jit(model.init)(jax.random.key(0), jnp.zeros((2, 32, 32, 3)))
    rng = np.random.default_rng(1)
    variables = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.standard_normal(a.shape),
                              jnp.float32), variables)
    save_checkpoint(str(jax_dir), 0, {"params": variables, "epoch": 0})
    sd = {k: torch.from_numpy(v.copy()) for k, v in export_vit_params(variables).items()}
    torch.save({"model": sd, "epoch": 0}, pth_dir / "checkpoint-0.pth")
    return str(jax_dir), str(pth_dir)


def test_serve_int8_matches_jax_surface(serve_checkpoints, monkeypatch):
    """The cls surface's int8 forward against the reference's (its jitted
    forward traced with the flag on), top-k probabilities within 1e-5; the
    port's server answers with --int8 1 and leaves the flag as it was."""
    import io
    import json
    import threading
    import urllib.request

    import test_torch_serve as S
    from mem_tpu.cli import serve as jax_serve
    from mem_tpu_torch.cli import serve

    monkeypatch.setattr(jax_vit, "INT8_GEMM", True)
    jax_dir, pth_dir = serve_checkpoints
    flags = S._MODEL_FLAGS + ["--int8", "1"]
    jassemble, jinfer, _ = jax_serve._build_cls(
        jax_serve.get_args(["--checkpoint", jax_dir] + flags), jnp.float32)
    targs = serve.get_args(["--checkpoint", pth_dir, "--device", "cpu"] + flags)
    _, tinfer, _ = serve._build_cls(targs, torch.float32, torch.device("cpu"))
    rng = np.random.default_rng(2)
    batch = jassemble([(S._events(rng, n), False) for n in (200, 0, 700, 50)], 4)
    jprobs, _ = (np.asarray(a) for a in jinfer(batch))
    with _int8_products(monkeypatch) as calls:
        tprobs, _ = serve.fetch(serve._int8_forwards(tinfer)(batch))
    assert len(calls) == 3 * 2
    np.testing.assert_allclose(tprobs, jprobs, rtol=0, atol=1e-5)
    assert tvit.INT8_GEMM is False

    httpd, state, _ = serve.build_server(targs)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        buf = io.BytesIO()
        np.save(buf, S._events(rng, 300))
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/predict",
                                     data=buf.getvalue(), method="POST")
        with _int8_products(monkeypatch) as calls:
            with urllib.request.urlopen(req, timeout=60) as r:
                code, body = r.status, json.loads(r.read())
        assert code == 200 and len(body["topk"]) == 3 and len(calls) == 3 * 2
    finally:
        with state.cv:
            state.stop = True
            state.cv.notify_all()
        httpd.shutdown()
        httpd.server_close()
    assert tvit.INT8_GEMM is False
