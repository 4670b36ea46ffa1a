"""The port's segmentation model held against the flax one with the same
weights (through ``seg_from_jax_params``, non-trivial ``batch_stats``) on the
same numpy inputs, module by module and as a whole, in f32 within 1e-4 of
each tensor's scale (max abs error <= 1e-4 * max(1, max |reference|): the
redrawn weights take 0..255 inputs to activations of ~1e3; the differences
are summation order, and the flax attention runs its einsum path on the
CPU, which scales q before the product). Small size: depth 2, width 32,
img_size 64."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from mem_tpu.models import segmentation as jseg
from mem_tpu.models.discrete_vae import TorchConvTranspose as JaxTorchConvTranspose
from mem_tpu.utils.torch_import import export_seg_params
from mem_tpu_torch.models import segmentation as tseg
from mem_tpu_torch.models.discrete_vae import TorchConvTranspose
from mem_tpu_torch.utils.weights import seg_from_jax_params

TOL = 1e-4
NUM_CLASSES = 5
_BACKBONE = dict(img_size=64, embed_dim=32, depth=2, num_heads=2, out_indices=(0, 0, 0, 1))
_HEADS = dict(head_channels=16, aux_channels=8)


def _redraw(variables, rng):
    """Every leaf redrawn from numpy so no bias, table, LayerScale or
    running statistic is trivially zero or one."""
    def redraw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            return np.asarray(0.5 + rng.random(leaf.shape), np.float32)
        base = 1.0 if "scale" in name else 0.0
        return np.asarray(base + 0.2 * rng.standard_normal(leaf.shape), np.float32)

    return jax.tree_util.tree_map_with_path(redraw, jax.device_get(variables))


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(3)
    fmodel = jseg.EncoderDecoder(num_classes=NUM_CLASSES, backbone_cfg=dict(_BACKBONE),
                                 dtype=jnp.float32, **_HEADS)
    variables = _redraw(jax.jit(fmodel.init)(jax.random.key(0), jnp.zeros((1, 44, 64, 3))), rng)
    tmodel = tseg.EncoderDecoder(num_classes=NUM_CLASSES, backbone_cfg=dict(_BACKBONE),
                                 dtype=torch.float32, **_HEADS)
    tmodel.load_state_dict(seg_from_jax_params(variables), strict=True)
    return fmodel, variables, tmodel.eval()


def _sub(variables, name):
    return {"params": variables["params"][name],
            "batch_stats": variables.get("batch_stats", {}).get(name, {})}


def _close(got, want, what=""):
    assert tuple(got.shape) == tuple(want.shape), (what, got.shape, want.shape)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())), err_msg=what)


def _features(rng, C=32):
    return [rng.standard_normal((2, s, s, C)).astype(np.float32) for s in (16, 8, 4, 2)]


@pytest.mark.parametrize("out_size,in_size", [(1, 7), (2, 7), (3, 16), (6, 16), (6, 5)])
def test_adaptive_pool_matrix(rng, out_size, in_size):
    m = tseg.adaptive_pool_matrix(out_size, in_size)
    np.testing.assert_array_equal(m, jseg.adaptive_pool_matrix(out_size, in_size))
    x = torch.from_numpy(rng.standard_normal((1, 1, in_size, in_size)).astype(np.float32))
    want = F.adaptive_avg_pool2d(x, out_size)[0, 0]
    got = torch.from_numpy(m) @ x[0, 0] @ torch.from_numpy(m).t()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_torch_conv_transpose_matches_flax(rng):
    fm = JaxTorchConvTranspose(7, kernel_size=2, stride=2, padding=0)
    x = rng.standard_normal((2, 4, 6, 5)).astype(np.float32)
    fv = _redraw(fm.init(jax.random.key(0), jnp.asarray(x)), rng)
    want = np.asarray(fm.apply(fv, jnp.asarray(x)))
    tm = TorchConvTranspose(5, 7, 2, stride=2)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(np.transpose(fv["params"]["kernel"], (2, 3, 0, 1))))
        tm.bias.copy_(torch.from_numpy(fv["params"]["bias"]))
    _close(tm(torch.from_numpy(x)), want)
    with pytest.raises(NotImplementedError, match="VAE"):
        TorchConvTranspose(5, 7, 4, stride=2, padding=1)


def test_seg_from_jax_params_equals_export_seg_params(pair):
    _, variables, tmodel = pair
    want = export_seg_params(variables)
    got = seg_from_jax_params(variables)
    assert set(got) == set(want) == set(tmodel.state_dict())
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_evbeit_matches_flax(pair, rng):
    _, variables, tmodel = pair
    x = (255 * rng.random((2, 44, 64, 3))).astype(np.float32)
    fb = jseg.EvBEiT(dtype=jnp.float32, **_BACKBONE)
    want = fb.apply(_sub(variables, "backbone"), jnp.asarray(x), False)
    got = tmodel.backbone(torch.from_numpy(x))
    assert [tuple(g.shape[1:3]) for g in got] == [(16, 16), (8, 8), (4, 4), (2, 2)]
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"feature {i}")


def test_uperhead_matches_flax(pair, rng):
    _, variables, tmodel = pair
    feats = _features(rng)
    fh = jseg.UPerHead(NUM_CLASSES, channels=16, dtype=jnp.float32)
    want = fh.apply(_sub(variables, "decode_head"), [jnp.asarray(f) for f in feats], False)
    _close(tmodel.decode_head([torch.from_numpy(f) for f in feats]), want)


def test_fcnhead_matches_flax(pair, rng):
    _, variables, tmodel = pair
    x = _features(rng)[2]
    fh = jseg.FCNHead(NUM_CLASSES, channels=8, dtype=jnp.float32)
    want = fh.apply(_sub(variables, "auxiliary_head"), jnp.asarray(x), False)
    _close(tmodel.auxiliary_head(torch.from_numpy(x)), want)


def test_encoder_decoder_matches_flax(pair, rng):
    fmodel, variables, tmodel = pair
    x = (255 * rng.random((2, 44, 64, 3))).astype(np.float32)
    want_logits, want_aux = jax.jit(lambda v, a: fmodel.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    with torch.inference_mode():
        logits, aux = tmodel(torch.from_numpy(x))
    assert logits.dtype == torch.float32 and logits.shape == (2, 44, 64, NUM_CLASSES)
    _close(logits, want_logits, "logits")
    _close(aux, want_aux, "aux")
    assert float(np.abs(np.asarray(want_logits)).mean()) > 1e-2    # not a trivial match


def test_bf16_model_keeps_reference_dtypes(pair, rng):
    """bf16 compute: f32 taps and BatchNorm, bf16 convolutions, f32 logits
    (segmentation.py:73, 141); close to the f32 model within bf16 rounding
    of two blocks and three conv layers (relative L2 5e-2)."""
    _, variables, tmodel = pair
    bf = tseg.EncoderDecoder(num_classes=NUM_CLASSES, backbone_cfg=dict(_BACKBONE),
                             dtype=torch.bfloat16, **_HEADS).eval()
    bf.load_state_dict(seg_from_jax_params(variables), strict=True)
    x = torch.from_numpy((255 * rng.random((1, 44, 64, 3))).astype(np.float32))
    feats = bf.backbone(x)
    assert [f.dtype for f in feats] == [torch.bfloat16, torch.bfloat16, torch.float32,
                                        torch.float32]
    logits, _ = bf(x)
    want, _ = tmodel(x)
    assert logits.dtype == torch.float32
    rel = (torch.linalg.norm(logits - want) / torch.linalg.norm(want)).item()
    assert rel <= 5e-2, rel


def test_train_mode_raises(pair):
    """``train=`` and the module's mode must agree, and training needs the
    step's generator for its dropouts."""
    _, _, tmodel = pair
    x = torch.zeros(1, 44, 64, 3)
    with pytest.raises(ValueError, match="eval\\(\\) mode"):
        tmodel(x, train=True)
    fresh = tseg.EncoderDecoder(num_classes=NUM_CLASSES, backbone_cfg=dict(_BACKBONE), **_HEADS)
    with pytest.raises(ValueError, match="train\\(\\) mode"):
        fresh(x)                      # a new nn.Module is in training mode
    with pytest.raises(ValueError, match="torch.Generator"):
        fresh(x, train=True)


def test_init_weights_is_seeded():
    def make(seed):
        m = tseg.EncoderDecoder(num_classes=NUM_CLASSES, backbone_cfg=dict(_BACKBONE), **_HEADS)
        m.init_weights(torch.Generator().manual_seed(seed))
        return m.eval()

    a, b, c = make(0), make(0), make(1)
    for (n, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), n
    assert not torch.equal(a.decode_head.fpn_bottleneck.conv.weight,
                           c.decode_head.fpn_bottleneck.conv.weight)
    logits, aux = a(255 * torch.rand(1, 44, 64, 3, generator=torch.Generator().manual_seed(0)))
    assert bool(torch.isfinite(logits).all()) and logits.std().item() > 1e-3


@pytest.mark.parametrize("scales,flips", [([1.0], [False]), ([0.75, 1.0, 1.25], [False, True])])
def test_tta_probs_matches_jax(rng, scales, flips):
    """The same per-pixel linear classifier through both tta_probs: the
    resizes (jax.image.resize bilinear vs the port's triangle filter), the
    flips and the probability sum agree within 1e-4."""
    x = (255 * rng.random((2, 20, 28, 3))).astype(np.float32)
    w = (0.02 * rng.standard_normal((3, NUM_CLASSES))).astype(np.float32)
    want = jseg.tta_probs(lambda a: a @ jnp.asarray(w), jnp.asarray(x), NUM_CLASSES,
                          scales, flips)
    got = tseg.tta_probs(lambda a: a @ torch.from_numpy(w), torch.from_numpy(x), NUM_CLASSES,
                         scales, flips)
    _close(got, want)
    np.testing.assert_allclose(got.sum(-1).numpy(), len(scales) * len(flips), atol=1e-4)


def test_confusion_matrix_and_metrics_match_jax(rng):
    pred = rng.integers(0, NUM_CLASSES, (2, 12, 9))
    labels = rng.integers(0, NUM_CLASSES, (2, 12, 9)).astype(np.int32)
    labels[:, :2] = 255
    labels[labels == 4] = 255              # a class with no ground truth: NaN IoU
    want = np.asarray(jseg.confusion_matrix(jnp.asarray(pred), jnp.asarray(labels),
                                            NUM_CLASSES))
    got = tseg.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(labels), NUM_CLASSES)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum().item() == (labels != 255).sum()
    a, b = tseg.seg_metrics(got.numpy()), jseg.seg_metrics(want)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-12, err_msg=k)


def test_seg_loss_matches_jax(rng):
    logits = rng.standard_normal((2, 6, 7, NUM_CLASSES)).astype(np.float32)
    aux = rng.standard_normal((2, 6, 7, NUM_CLASSES)).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES, (2, 6, 7)).astype(np.int32)
    labels[0, :2] = 255
    want = float(jseg.seg_loss(jnp.asarray(logits), jnp.asarray(aux), jnp.asarray(labels),
                               NUM_CLASSES))
    got = tseg.seg_loss(torch.from_numpy(logits), torch.from_numpy(aux),
                        torch.from_numpy(labels), NUM_CLASSES)
    assert abs(got.item() - want) <= 1e-5 * abs(want)
    all_ignored = torch.full((2, 6, 7), 255, dtype=torch.int32)
    assert tseg.seg_loss(torch.from_numpy(logits), torch.from_numpy(aux), all_ignored,
                         NUM_CLASSES).item() == 0.0
