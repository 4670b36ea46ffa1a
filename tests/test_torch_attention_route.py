"""The reference's attention routing, held on both packages: which of
``fused_attention``'s kernels a shape reaches (the reference's own choice,
read off the Pallas kernel it would hand to ``pallas_call``), which branch
``models.vit.Attention`` takes under ``ENABLED`` x ``FLAT_ATTN`` x
``FLAT_ATTN_LONG`` around each of its guards (both modules spied on, the
rule stated nowhere here), the einsum path's bf16 roundings at the shapes the
guards keep off the kernels, and the small segmentor on the head-major path
(K5b with K5d or K5e) against flax."""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import mem_tpu.models.vit as jax_vit
import mem_tpu.ops.attention as jax_attention
from mem_tpu.models import segmentation as jseg
from mem_tpu_torch.models import segmentation as tseg
from mem_tpu_torch.models import vit as tvit
from mem_tpu_torch.ops import attention as A
from mem_tpu_torch.utils.weights import seg_from_jax_params

# the reference's kernel bodies -> the port's launch-counter names
_KERNELS = {"_fwd_hb_kernel": "fused_attention", "_fwd_kernel": "fused_attention_long",
            "_bwd_hb_kernel": "fused_attention_bwd", "_bwd_kernel": "fused_attention_bwd_whole",
            "_bwd_block_merged_kernel": "fused_attention_bwd_long"}


def _patch_both(monkeypatch, **values):
    for name, value in values.items():
        monkeypatch.setattr(jax_attention, name, value)
        monkeypatch.setattr(A, name, value)


def test_routing_constants_are_the_reference_s():
    assert (A.ENABLED, A.QBLK, A._WHOLE_BWD_MAX_N, A._HB_MAX_BIAS_BYTES) == (
        jax_attention.ENABLED, jax_attention.QBLK, jax_attention._WHOLE_BWD_MAX_N,
        jax_attention._HB_MAX_BIAS_BYTES) == (False, 256, 448, 5 * 1024 * 1024)


def _reference_branch(monkeypatch, H, N):
    """The kernels the reference's ``_fa_fwd`` and ``_fa_bwd`` hand to
    ``pallas_call`` at (1, H, N, 8), traced abstractly (nothing runs)."""
    called = []

    class _Pallas:
        def __getattr__(self, name):
            return getattr(pl, name)

        @staticmethod
        def pallas_call(kernel, out_shape, **_):
            called.append(kernel.func.__name__)
            return lambda *a: jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), out_shape)

    monkeypatch.setattr(jax_attention, "pl", _Pallas())
    x = jax.ShapeDtypeStruct((1, H, N, 8), jnp.float32)
    b = jax.ShapeDtypeStruct((H, N, N), jnp.float32)
    jax.eval_shape(lambda q, bias: jax_attention._fa_fwd(q, q, q, bias, 1.0, True)[0], x, b)
    jax.eval_shape(lambda q, bias: jax_attention._fa_bwd(1.0, True, (q, q, q, bias), q), x, b)
    return tuple(_KERNELS[c] for c in called)


@pytest.mark.parametrize("H,N,patch", [
    (12, 197, {}), (12, 330, {}), (12, 331, {}), (12, 401, {}), (12, 448, {}), (12, 449, {}),
    (12, 1025, {}), (1, 1144, {}), (1, 1145, {}), (4, 449, {}), (16, 286, {}),
    (2, 21, {"_HB_MAX_BIAS_BYTES": 0}), (2, 449, {"_HB_MAX_BIAS_BYTES": 0}),
    (2, 21, {"_HB_MAX_BIAS_BYTES": 0, "_WHOLE_BWD_MAX_N": 8}),
    (12, 1025, {"_HB_MAX_BIAS_BYTES": 1 << 30})])
def test_branch_choice_is_the_reference_s(monkeypatch, H, N, patch):
    """The port's ``fused_attention_route`` names the kernels the reference
    picks, with the routing constants at their values and moved on both
    sides at once."""
    _patch_both(monkeypatch, **patch)
    assert A.fused_attention_route(H, N) == _reference_branch(monkeypatch, H, N)


# -- the model's branch --------------------------------------------------------

class _OnAccelerator:
    """The ``jax`` module as the reference's vit.py sees it on its
    accelerator: its routing reads ``jax.devices()[0].platform`` (vit.py:363)
    and takes its kernels at head-blocked-eligible shapes only off the CPU.
    The port takes the card's branch on the CPU too."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def devices():
        return [types.SimpleNamespace(platform="tpu")]


_BRANCHES = {"fused_attention": "head-major", "fused_attention_flat": "flat",
             "fused_attention_flat_long": "flat"}


def _attention_pair(H, head_dim):
    """A flax Attention and its parameters (abstract), and the port's module
    on the meta device: the branch is all that is read, so nothing is
    computed on either side."""
    dim = H * head_dim
    fattn = jax_vit.Attention(dim, H)
    params = jax.eval_shape(fattn.init, jax.random.key(0), jnp.zeros((1, 8, dim)))
    return fattn, params, tvit.Attention(dim, H, device="meta")


@pytest.mark.parametrize("enabled", [False, True])
@pytest.mark.parametrize("flat_attn", [True, False])
@pytest.mark.parametrize("flat_attn_long", [True, False])
def test_attention_takes_the_reference_s_branch(monkeypatch, enabled, flat_attn,
                                                flat_attn_long):
    """Around each guard of the reference's rule (N = 7 / 8 and 1056 / 1057,
    head dim 4 / 8, the head-blocked budget at 12 heads N = 330 / 331, and
    N = 511 / 512) both Attention modules take the same branch: flat,
    head-major or einsum (no kernel). Flat is one branch: within it the port
    splits K2 / K3 at the card's FLAT_MAX_N (ops.attention.attention_route).
    The flax module is traced (``jax.eval_shape``), the port's runs on meta
    tensors."""
    monkeypatch.setattr(jax_attention, "ENABLED", enabled)
    monkeypatch.setattr(A, "ENABLED", enabled)
    for mod in (jax_vit, tvit):
        monkeypatch.setattr(mod, "FLAT_ATTN", flat_attn)
        monkeypatch.setattr(mod, "FLAT_ATTN_LONG", flat_attn_long)
    calls = {"jax": [], "torch": []}
    monkeypatch.setattr(jax_vit, "jax", _OnAccelerator())
    for name, branch in _BRANCHES.items():
        for mod, side in ((jax_attention, "jax"), (tvit, "torch")):
            # each returns its q: (B, H, N, D) or (B, N, H*D), the output's shape
            monkeypatch.setattr(mod, name,
                                lambda q, *a, side=side, branch=branch:
                                calls[side].append(branch) or q)

    def taken_by(side, run):
        before = len(calls[side])
        run()
        return calls[side][before] if len(calls[side]) > before else "einsum"

    taken = {"jax": [], "torch": []}
    for head_dim in (8, 4):
        fattn, params, tattn = _attention_pair(12, head_dim)
        for N in (7, 8, 330, 331, 511, 512, 1056, 1057):
            x = jax.ShapeDtypeStruct((1, N, 12 * head_dim), jnp.float32)
            taken["jax"].append((N, head_dim, taken_by(
                "jax", lambda: jax.eval_shape(fattn.apply, params, x))))
            taken["torch"].append((N, head_dim, taken_by(
                "torch", lambda: tattn(torch.empty(x.shape, device="meta")))))
    assert taken["torch"] == taken["jax"]
    assert {b for *_, b in taken["jax"]} >= {"einsum", "flat" if flat_attn else "head-major"}


# -- F2: the shapes the guards keep off the kernels, in bf16 --------------------

@pytest.mark.parametrize("H,head_dim,N", [(2, 4, 12), (2, 8, 5)], ids=["head_dim4", "n5"])
def test_off_kernel_shapes_round_as_the_einsum_path(rng, H, head_dim, N):
    """Head dim 4 and N < 8 take the einsum path on both sides, whose scores
    come from q * scale rounded to bf16 (vit.py:528-535): bf16 outputs within
    one bf16 step (2^-8) of the larger of 1 and the output's max abs."""
    dim = H * head_dim
    fattn = jax_vit.Attention(dim, H, dtype=jnp.bfloat16)
    params = jax.tree.map(lambda p: jnp.asarray(0.5 * rng.standard_normal(p.shape), jnp.float32),
                          jax.eval_shape(fattn.init, jax.random.key(0), jnp.zeros((1, N, dim))))
    p = params["params"]
    tattn = tvit.Attention(dim, H, dtype=torch.bfloat16)
    with torch.no_grad():
        for t, a in ((tattn.qkv.weight, p["qkv_kernel"].T), (tattn.q_bias, p["q_bias"]),
                     (tattn.v_bias, p["v_bias"]), (tattn.proj.weight, p["proj"]["kernel"].T),
                     (tattn.proj.bias, p["proj"]["bias"])):
            t.copy_(torch.tensor(np.asarray(a)))
    assert not tattn.use_fused(N)
    x = rng.standard_normal((3, N, dim)).astype(np.float32)
    want = np.asarray(jax.jit(fattn.apply)(params, jnp.asarray(x, jnp.bfloat16)), np.float32)
    with torch.no_grad():
        got = tattn(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= 2 ** -8 * max(1.0, np.abs(want).max())


# -- the segmentor on the head-major path -----------------------------------------

_NUM_CLASSES = 5
_BACKBONE = dict(img_size=64, embed_dim=32, depth=2, num_heads=2, out_indices=(0, 0, 0, 1))
_HEADS = dict(head_channels=16, aux_channels=8)


def _redraw(variables, rng):
    def redraw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            return np.asarray(0.5 + rng.random(leaf.shape), np.float32)
        base = 1.0 if "scale" in name else 0.0
        return np.asarray(base + 0.2 * rng.standard_normal(leaf.shape), np.float32)

    return jax.tree_util.tree_map_with_path(redraw, jax.device_get(variables))


@pytest.fixture(scope="module")
def seg_pair():
    """The flax segmentor with redrawn variables, and their port state_dict."""
    fmodel = jseg.EncoderDecoder(num_classes=_NUM_CLASSES, backbone_cfg=dict(_BACKBONE),
                                 dtype=jnp.float32, **_HEADS)
    variables = _redraw(jax.jit(fmodel.init)(jax.random.key(0), jnp.zeros((1, 44, 64, 3))),
                        np.random.default_rng(3))
    return fmodel, variables, seg_from_jax_params(variables)


@pytest.mark.parametrize("toggle,bwd", [("FLAT_ATTN_LONG", "fused_attention_bwd_whole"),
                                        ("FLAT_ATTN", "fused_attention_bwd_whole"),
                                        ("FLAT_ATTN_LONG", "fused_attention_bwd_long")])
def test_segmentor_on_the_head_major_kernels_matches_flax(rng, monkeypatch, seg_pair, toggle,
                                                          bwd):
    """The small segmentor (N = 17) with ``toggle`` off, ``ENABLED`` on and
    the head-blocked budget at 0 on both sides, so both take K5b forward and
    K5d backward, or K5e with ``_WHOLE_BWD_MAX_N`` = 8 (flax in interpret
    mode): logits to 1e-4 of their scale and the gradient of one loss of both
    outputs for every parameter to 1e-4 relative L2, f32
    (test_torch_segmentation's and test_torch_seg_train's bounds)."""
    _patch_both(monkeypatch, ENABLED=True, _HB_MAX_BIAS_BYTES=0,
                **({"_WHOLE_BWD_MAX_N": 8} if bwd == "fused_attention_bwd_long" else {}))
    monkeypatch.setattr(jax_vit, toggle, False)
    monkeypatch.setattr(tvit, toggle, False)
    reached = []
    for name in ("fused_attention_long_reference", "fused_attention_bwd_whole_reference",
                 "fused_attention_bwd_long_reference"):
        monkeypatch.setattr(A, name, lambda *a, fn=getattr(A, name), name=name:
                            reached.append(name) or fn(*a))
    fmodel, variables, state = seg_pair
    tmodel = tseg.EncoderDecoder(num_classes=_NUM_CLASSES, backbone_cfg=dict(_BACKBONE),
                                 dtype=torch.float32, **_HEADS)
    tmodel.load_state_dict(state, strict=True)
    x = (255 * rng.random((2, 44, 64, 3))).astype(np.float32)
    got = tmodel.eval()(torch.from_numpy(x))
    ws = [rng.standard_normal(t.shape).astype(np.float32) for t in got]

    def loss(params):
        outs = fmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            jnp.asarray(x), train=False)
        return sum((o * w).sum() for o, w in zip(outs, ws)), outs[0]

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    want = np.asarray(want)
    np.testing.assert_allclose(got[0].detach().numpy(), want, rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(want).max())))
    sum((o * torch.from_numpy(w)).sum() for o, w in zip(got, ws)).backward()
    assert reached[:2] == ["fused_attention_long_reference"] * 2
    assert reached[2:] == [bwd + "_reference"] * 2
    gwant = seg_from_jax_params(jax.device_get(
        {"params": grads, "batch_stats": variables["batch_stats"]}))
    total = np.sqrt(sum(float((g.double() ** 2).sum()) for g in gwant.values()))
    for name, p in tmodel.named_parameters():
        g, ref = p.grad.double().numpy(), gwant[name].double().numpy()
        if np.linalg.norm(ref) < 1e-8 * total:      # rounding noise on both sides
            continue
        assert np.linalg.norm(g - ref) <= 1e-4 * np.linalg.norm(ref), name
