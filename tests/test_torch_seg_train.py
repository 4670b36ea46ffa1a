"""The port's segmentation training held against the JAX package on the CPU
at a small size (depth 2, width 32, img_size 64): BatchNorm in training mode
against flax, the heads and the whole segmentor with ``train=True`` (loss and
every gradient against ``jax.grad``), the train half of the preprocessing
(resize jitter, the photometric RandAugment pool, flips), layer decay and the
poly schedule, three whole train steps against the jitted JAX step, the
checkpoint surgery, and ``train_seg`` on ``--device cpu``. Dropout and
drop-path are 0 wherever two frameworks are compared: their generators draw
other bits."""
import copy
import os

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

import mem_tpu.ops.attention as jax_attention
import mem_tpu.ops.voxelize as jax_voxelize
from mem_tpu.cli import train_seg as jax_train_seg
from mem_tpu.data import seg_pipeline as jsp
from mem_tpu.models import segmentation as jseg
from mem_tpu.models.registry import create_model as jax_create_model
from mem_tpu.ops import rand_augment as jax_ra
from mem_tpu.train import optim as jax_optim
from mem_tpu.utils import surgery as jax_surgery
from mem_tpu_torch.cli import test_seg as test_seg_cli
from mem_tpu_torch.cli import train_seg as cli
from mem_tpu_torch.data import seg_pipeline as tsp
from mem_tpu_torch.models import segmentation as tseg
from mem_tpu_torch.ops import rand_augment as ra
from mem_tpu_torch.train import optim
from mem_tpu_torch.train.schedules import poly_lr_schedule
from mem_tpu_torch.train.steps import make_seg_steps
from mem_tpu_torch.utils import surgery
from mem_tpu_torch.utils.checkpoint import load_checkpoint
from mem_tpu_torch.utils.weights import from_jax_params, seg_from_jax_params

NUM_CLASSES = 5
_BACKBONE = dict(img_size=64, embed_dim=32, depth=2, num_heads=2, out_indices=(0, 0, 0, 1),
                 drop_path_rate=0.0)
_HEADS = dict(head_channels=16, aux_channels=8, dropout_ratio=0.0)
GRAD_TOL = 1e-4      # relative L2 of a gradient, f32 both sides
# The pool-scale-1 branch of the PSP module normalises B values per channel
# (a 1x1 map): flax's fast variance E[x^2] - E[x]^2 cancels there in f32 on
# both sides, and the gradients of that BatchNorm's scale and of the convolution
# in front of it carry that rounding, amplified by rsqrt(var + eps).
GRAD_TOL_ILL = 1e-2
_ILL_CONDITIONED = ("psp_0.conv.weight", "psp_0.bn.weight")
# a gradient below this share of the global norm is rounding noise on both
# sides (the bias of a convolution that feeds a BatchNorm has none; the 0..255
# inputs make the patch embedding's gradient 1e4 times a block's)
GRAD_FLOOR = 1e-8


def _redraw(variables, rng):
    """Products keep flax's fan-in scaled init; every bias, table,
    LayerScale, BatchNorm scale and running statistic is redrawn from numpy."""
    def redraw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            return np.asarray(leaf)
        if "'var'" in name:
            return np.asarray(0.5 + rng.random(leaf.shape), np.float32)
        base = 1.0 if "scale" in name else 0.0
        return np.asarray(base + 0.2 * rng.standard_normal(leaf.shape), np.float32)

    return jax.tree_util.tree_map_with_path(redraw, jax.device_get(variables))


def _segmentors(rng):
    fmodel = jseg.EncoderDecoder(num_classes=NUM_CLASSES, backbone_cfg=dict(_BACKBONE),
                                 dtype=jnp.float32, **_HEADS)
    variables = _redraw(jax.jit(fmodel.init)(jax.random.key(0), jnp.zeros((1, 44, 64, 3))), rng)
    tmodel = tseg.EncoderDecoder(num_classes=NUM_CLASSES, backbone_cfg=dict(_BACKBONE),
                                 dtype=torch.float32, **_HEADS)
    tmodel.load_state_dict(seg_from_jax_params(variables), strict=True)
    return fmodel, variables, tmodel


def _sub(variables, name):
    return {"params": variables["params"][name], "batch_stats": variables["batch_stats"][name]}


def _rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


def _assert_grads_match(tmodel, prefix, jax_grads_sd):
    """Every parameter's gradient against the converted ``jax.grad`` tree."""
    want = {k: v.numpy() for k, v in jax_grads_sd.items() if k.startswith(prefix)}
    got = {prefix + n: p.grad.numpy() for n, p in tmodel.named_parameters()}
    assert set(got) <= set(want)
    total = np.sqrt(sum(float((w.astype(np.float64) ** 2).sum()) for w in want.values()))
    compared = 0
    for name, g in got.items():
        w = want[name]
        if np.linalg.norm(w) < GRAD_FLOOR * total:
            assert np.linalg.norm(g) < 10 * GRAD_FLOOR * total, name
            continue
        tol = GRAD_TOL_ILL if name.endswith(_ILL_CONDITIONED) else GRAD_TOL
        assert _rel_l2(g, w) <= tol, (name, _rel_l2(g, w))
        compared += 1
    assert compared >= 0.7 * len(got)


# -- BatchNorm and the modules in training mode --------------------------------

def test_batchnorm_train_matches_flax(rng):
    """Batch statistics over (B, H, W), the biased variance for normalising
    and for the running update, momentum 0.9: outputs and the updated
    batch_stats to 1e-5; eval mode then reads the updated buffers."""
    x = (3.0 + 2.0 * rng.standard_normal((3, 5, 6, 7))).astype(np.float32)
    fbn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jnp.float32)
    fv = _redraw(fbn.init(jax.random.key(0), jnp.asarray(x)), rng)
    want, new = fbn.apply(fv, jnp.asarray(x), mutable=["batch_stats"])
    tbn = tseg.BatchNorm(7)
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(fv["params"]["scale"]))
        tbn.bias.copy_(torch.from_numpy(fv["params"]["bias"]))
        tbn.running_mean.copy_(torch.from_numpy(fv["batch_stats"]["mean"]))
        tbn.running_var.copy_(torch.from_numpy(fv["batch_stats"]["var"]))
    got = tbn.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tbn.running_mean.numpy(), np.asarray(new["batch_stats"]["mean"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tbn.running_var.numpy(), np.asarray(new["batch_stats"]["var"]),
                               rtol=0, atol=1e-5)
    # not PyTorch's conventions: the running variance is the biased one
    biased = 0.9 * fv["batch_stats"]["var"] + 0.1 * x.reshape(-1, 7).var(axis=0)
    np.testing.assert_allclose(tbn.running_var.numpy(), biased, rtol=1e-5)
    feval = nn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5)
    want_eval = feval.apply({"params": fv["params"], **new}, jnp.asarray(x))
    np.testing.assert_allclose(tbn.eval()(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want_eval), rtol=0, atol=1e-5)


@pytest.mark.parametrize("head", ["decode_head", "auxiliary_head"])
def test_heads_train_mode_match_flax(rng, head):
    """UPerHead / FCNHead with ``train=True`` (dropout 0): the logits, the
    updated BatchNorm buffers and the gradient of a scalar of the logits with
    respect to every parameter."""
    _, variables, tmodel = _segmentors(rng)
    feats = [rng.standard_normal((3, s, s, 32)).astype(np.float32) for s in (16, 8, 4, 2)]
    weights = rng.standard_normal((3, 16, 16, NUM_CLASSES) if head == "decode_head"
                                  else (3, 4, 4, NUM_CLASSES)).astype(np.float32)
    if head == "decode_head":
        fh = jseg.UPerHead(NUM_CLASSES, channels=16, dropout_ratio=0.0, dtype=jnp.float32)
        fin, tin = [jnp.asarray(f) for f in feats], [torch.from_numpy(f) for f in feats]
    else:
        fh = jseg.FCNHead(NUM_CLASSES, channels=8, dropout_ratio=0.0, dtype=jnp.float32)
        fin, tin = jnp.asarray(feats[2]), torch.from_numpy(feats[2])
    sub = _sub(variables, head)

    def f(params):
        out, new = fh.apply({"params": params, "batch_stats": sub["batch_stats"]}, fin, True,
                            mutable=["batch_stats"])
        return (out * weights).sum(), (out, new)

    (_, (want, new)), grads = jax.value_and_grad(f, has_aux=True)(sub["params"])
    th = getattr(tmodel, head).train()
    got = th(tin, train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(want).max())))
    (got * torch.from_numpy(weights)).sum().backward()
    full = {"params": {**variables["params"], head: grads},
            "batch_stats": {**variables["batch_stats"], head: new["batch_stats"]}}
    converted = seg_from_jax_params(jax.device_get(full))
    _assert_grads_match(th, head + ".", converted)
    for name, buf in th.named_buffers():
        np.testing.assert_allclose(buf.numpy(), converted[f"{head}.{name}"].numpy(), rtol=0,
                                   atol=1e-5 * max(1.0, float(buf.abs().max())), err_msg=name)


def test_encoder_decoder_train_loss_and_gradients_match_jax(rng):
    """The whole segmentor with ``train=True`` (dropout and drop-path 0):
    ``seg_loss`` to 1e-5 relative, every gradient to 1e-4 relative L2 against
    ``jax.grad``, the updated buffers to 1e-4 of their scale (a fast variance
    of activations of ~1e2 cancels), and the taps
    stay f32."""
    fmodel, variables, tmodel = _segmentors(rng)
    x = (255 * rng.random((3, 44, 64, 3))).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES, (3, 44, 64)).astype(np.int32)
    labels[:, :4] = 255

    def f(params):
        (logits, aux), new = fmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x),
            train=True, mutable=["batch_stats"])
        return jseg.seg_loss(logits, aux, jnp.asarray(labels), NUM_CLASSES), new

    (want, new), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(variables["params"])
    tmodel.train()
    feats = copy.deepcopy(tmodel).backbone(torch.from_numpy(x), train=True)
    assert feats[2].dtype == feats[3].dtype == torch.float32
    logits, aux = tmodel(torch.from_numpy(x), train=True)
    loss = tseg.seg_loss(logits, aux, torch.from_numpy(labels), NUM_CLASSES)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    tmodel.zero_grad()
    loss.backward()
    converted = seg_from_jax_params(jax.device_get(
        {"params": grads, "batch_stats": new["batch_stats"]}))
    _assert_grads_match(tmodel, "", converted)
    for name, buf in tmodel.named_buffers():
        if "running_" in name:
            np.testing.assert_allclose(buf.numpy(), converted[name].numpy(), rtol=0,
                                       atol=1e-4 * max(1.0, float(buf.abs().max())),
                                       err_msg=name)


def test_train_mode_draws_dropout_from_the_generator(rng):
    """With dropout on, training needs the step's generator, the same seed
    gives the same logits, another seed others, and eval ignores it."""
    _, variables, _ = _segmentors(rng)
    model = tseg.EncoderDecoder(num_classes=NUM_CLASSES, dtype=torch.float32,
                                backbone_cfg=dict(_BACKBONE, drop_path_rate=0.2),
                                head_channels=16, aux_channels=8, dropout_ratio=0.1)
    model.load_state_dict(seg_from_jax_params(variables), strict=True)
    x = torch.from_numpy((255 * rng.random((2, 44, 64, 3))).astype(np.float32))
    with pytest.raises(ValueError, match="torch.Generator"):
        model.train()(x, train=True)

    def run(seed):
        with torch.no_grad():
            return model(x, train=True, generator=torch.Generator().manual_seed(seed))[0]

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)


# -- the train half of the preprocessing ----------------------------------------

def test_apply_resize_jitter_matches_jax(rng):
    """Bilinear image to 1e-5 of 255, nearest labels exactly, at ratios and
    offsets as the iterator draws them (and one identity row)."""
    img = rng.integers(0, 256, (3, 44, 64, 3)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 44, 64)).astype(np.int32)
    labels[:, :3] = 255
    rj = np.array([[1.0, 1.0, 0.0, 0.0], [1.0091, 1.0094, 0.0, 1.0], [1.05, 1.03, 2.0, 1.0]],
                  np.float32)
    want_img, want_lab = jsp.apply_resize_jitter(jnp.asarray(img), jnp.asarray(labels),
                                                 jnp.asarray(rj))
    got_img, got_lab = tsp.apply_resize_jitter(torch.from_numpy(img), torch.from_numpy(labels),
                                               torch.from_numpy(rj))
    assert got_lab.dtype == torch.int32
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), rtol=0, atol=1e-5 * 255)
    np.testing.assert_array_equal(got_lab.numpy(), np.asarray(want_lab))
    np.testing.assert_array_equal(got_img[0].numpy(), img[0])       # ratio 1, offset 0
    assert not np.array_equal(got_lab[2].numpy(), labels[2])
    for nearest in (False, True):
        m = tsp._interp_matrices(44, torch.from_numpy(rj[:, 0]), torch.from_numpy(rj[:, 2]),
                                 nearest)
        for b in range(3):
            np.testing.assert_allclose(
                m[b].numpy(), np.asarray(jsp._interp_matrices(44, rj[b, 0], rj[b, 2], nearest)),
                rtol=0, atol=1e-6)


@pytest.mark.parametrize("batch_ops", [False, True])
def test_photometric_pool_draws_and_ops(rng, batch_ops):
    """``geometric=False``: the ops come from the reference's photometric
    pool, bins in [0, 10]; the batch is augmented as the JAX ops applied one
    by one at the same draws (within one uint8 level: a multiply-add that XLA
    contracts can flip a truncation)."""
    assert ra.PHOTOMETRIC_IDS == tuple(int(i) for i in jax_ra._PHOTOMETRIC_IDS)
    seeds = np.arange(400, dtype=np.uint32) * 7919 + 3
    d = tsp.draw_seg_train_aug(seeds, batch_ops)
    assert set(np.unique(d["ra_ops"])) <= set(ra.PHOTOMETRIC_IDS)
    assert d["ra_bins"].min() == 0 and d["ra_bins"].max() == 10
    assert set(np.unique(d["ra_signs"])) == {0, 1}
    if batch_ops:
        assert (d["ra_ops"] == d["ra_batch_ops"][None]).all()
    else:
        assert "ra_batch_ops" not in d
        assert set(np.unique(d["ra_ops"])) == set(ra.PHOTOMETRIC_IDS)
    again = tsp.draw_seg_train_aug(seeds, batch_ops)
    assert all(np.array_equal(again[k], d[k]) for k in d)

    B, H, W = 4, 24, 20
    imgs = rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8)
    ops = np.array([[6, 13], [0, 7], [10, 12], [9, 8]], np.int32)
    if batch_ops:
        ops[:] = ops[0]
    bins = rng.integers(0, 11, (B, 2)).astype(np.int32)
    signs = rng.integers(0, 2, (B, 2)).astype(np.int32)
    got = ra.rand_augment_batch(torch.from_numpy(imgs), torch.from_numpy(ops),
                                torch.from_numpy(bins), torch.from_numpy(signs),
                                ops[0] if batch_ops else None, geometric=False)
    assert got.dtype == torch.uint8
    table = np.asarray(jax_ra._magnitude_table(H, W))
    signed = np.asarray(jax_ra._SIGNED)
    for b in range(B):
        x = jnp.asarray(imgs[b], jnp.float32)
        for r in range(2):
            mag = table[ops[b, r], bins[b, r]]
            if signed[ops[b, r]] and signs[b, r] == 1:
                mag = -mag
            x = jax_ra._apply_op(x, int(ops[b, r]), jnp.float32(mag))
        want = np.clip(np.asarray(x), 0, 255).astype(np.uint8).astype(np.int32)
        diff = np.abs(got[b].numpy().astype(np.int32) - want)
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.02, (b, diff.max(), (diff > 0).mean())


def _seg_batch(rng, B=2, N=30000):
    xyp = np.zeros((B, N, 3), np.int16)
    xyp[..., 0] = rng.integers(0, 640, (B, N))
    xyp[..., 1] = np.sort(rng.integers(0, 440, (B, N)), axis=1)
    xyp[:, : N // 2, 0] = np.clip(rng.normal(250, 70, (B, N // 2)), 0, 639).astype(np.int16)
    xyp[..., 2] = rng.choice([-1, 1], (B, N))
    labels = np.repeat(np.repeat(rng.integers(0, NUM_CLASSES, (B, 11, 16)), 40, axis=1),
                       40, axis=2).astype(np.int32)
    labels[:, :10] = 255
    return {"events_xyp": xyp, "n_valid": np.full(B, N, np.int32), "label": labels,
            "flip": np.arange(B) % 2 == 0,
            "resize_jitter": np.stack([np.array([1.0 + 0.004 * b, 1.0 + 0.006 * b, b % 4, b % 6],
                                                np.float32) for b in range(1, B + 1)]),
            "aug_seed": (np.arange(B) + 11).astype(np.uint32)}


def _as_torch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32 else v)
            for k, v in batch.items()}


@pytest.mark.parametrize("jitter", [True, False])
def test_seg_preprocess_batch_train_equals_jax(rng, jitter):
    """is_train=True with RandAugment off: voxelize -> resize jitter -> hot
    pixels -> /max * 255 -> uint8 truncation -> f32 -> flips. The images are
    whole numbers on both sides and equal (a level may differ where the
    jitter's f32 products round across a truncation: at most 1e-4 of the
    pixels, by one level); the labels are equal."""
    batch = _seg_batch(rng, B=3)
    if not jitter:
        batch.pop("resize_jitter")
    want_img, want_lab = jsp.seg_preprocess_batch(
        {k: jnp.asarray(v) for k, v in batch.items()}, True, False, y_sorted=True)
    img, lab = tsp.seg_preprocess_batch(_as_torch(batch), True, False, y_sorted=True)
    want_img = np.asarray(want_img)
    assert img.dtype == torch.float32 and img.shape == (3, 440, 640, 3)
    assert torch.equal(img, img.round()) and img.max().item() == 255.0
    diff = np.abs(img.numpy() - want_img)
    assert diff.max() <= 1.0 and (diff > 0).mean() <= 1e-4, (diff.max(), (diff > 0).mean())
    np.testing.assert_array_equal(lab.numpy(), np.asarray(want_lab))
    # sample 0 is flipped, sample 1 is not
    plain, _ = tsp.seg_preprocess_batch({**_as_torch(batch), "flip": torch.zeros(3, dtype=bool)},
                                        True, False, y_sorted=True)
    assert torch.equal(img[0], plain[0].flip(1)) and torch.equal(img[1], plain[1])
    assert int((img > 0).sum()) > 20000


def test_seg_preprocess_batch_train_rand_augment_modes(rng):
    """With RandAugment on the draws ride in the batch; both batch_ops modes
    give whole-number images that differ from the un-augmented ones."""
    batch = _seg_batch(rng, B=2)
    plain, _ = tsp.seg_preprocess_batch(_as_torch(batch), True, False, y_sorted=True)
    for batch_ops in (False, True):
        draws = tsp.draw_seg_train_aug(batch["aug_seed"], batch_ops)
        tb = _as_torch(batch)
        tb.update({k: v if k == "ra_batch_ops" else torch.from_numpy(v)
                   for k, v in draws.items()})
        img, lab = tsp.seg_preprocess_batch(tb, True, True, batch_ops, y_sorted=True)
        assert torch.equal(img, img.round()) and 0 <= img.min() and img.max() <= 255
        assert lab.shape == (2, 440, 640)
        if any(int(o) != 0 for o in draws["ra_ops"].ravel()):
            assert not torch.equal(img, plain)


# -- optimizer and schedule ---------------------------------------------------

def test_layer_decay_and_wd_mask_equal_jax_trees(rng):
    """For every parameter of the segmentor: the lr scale of
    ``build_lr_scale_tree`` and the mask of ``build_wd_mask_tree`` on
    ``{"params": params}``, as train_seg builds them."""
    depth, decay = 2, 0.65
    _, variables, tmodel = _segmentors(rng)
    wrapped = {"params": variables["params"]}
    scales = jax_optim.build_lr_scale_tree(wrapped, decay, depth)["params"]
    masks = jax_optim.build_wd_mask_tree(wrapped)["params"]

    def as_sd(tree):
        filled = jax.tree.map(lambda s, p: np.full(p.shape, s, np.float32), tree,
                              variables["params"])
        return seg_from_jax_params({"params": filled, "batch_stats": variables["batch_stats"]})

    want_scale, want_mask = as_sd(scales), as_sd(masks)
    for name, p in tmodel.named_parameters():
        s = optim.lr_scale(name, decay, depth)
        np.testing.assert_allclose(want_scale[name].numpy(), s, rtol=1e-6, err_msg=name)
        assert (want_mask[name].numpy() == float(optim.decays(name, p))).all(), name
    values = optim.layer_decay_values(decay, depth)
    assert values == jax_optim.layer_decay_values(decay, depth)
    assert optim.lr_scale("backbone.patch_embed.proj.weight", decay, depth) == values[0]
    assert optim.lr_scale("backbone.blocks.1.attn.relative_position_bias_table",
                          decay, depth) == values[2]
    assert optim.lr_scale("decode_head.conv_seg.weight", decay, depth) == 1.0
    assert optim.lr_scale("rel_pos_bias.relative_position_bias_table", decay, depth) == 1.0
    assert optim.lr_scale("backbone.blocks.0.mlp.fc1.weight", None, depth) == 1.0

    opt = optim.create_optimizer(tmodel, 1e-3, 0.05, layer_decay=decay, num_layers=depth,
                                 betas=cli.SEG_BETAS)
    assert opt.defaults["betas"] == (0.9, 0.999) and opt.defaults["eps"] == 1e-8
    params = dict(tmodel.named_parameters())
    seen = 0
    optim.set_schedule(opt, 2e-3, 0.07)
    for g in opt.param_groups:
        for p in g["params"]:
            name = next(n for n, q in params.items() if q is p)
            assert g["lr"] == pytest.approx(2e-3 * optim.lr_scale(name, decay, depth))
            assert g["weight_decay"] == (0.07 if optim.decays(name, p) else 0.0)
            seen += 1
    assert seen == len(params)


@pytest.mark.parametrize("step", [0, 1, 1499, 1500, 159999, 160000])
def test_poly_lr_schedule_matches_jax(step):
    want = float(jax_train_seg.poly_lr_schedule(5e-4, 160000)(step))
    got = poly_lr_schedule(5e-4, 160000)(step)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert poly_lr_schedule(5e-4, 160000)(160000) == 0.0


# -- three whole steps ----------------------------------------------------------

@pytest.fixture(scope="module")
def three_seg_steps():
    """3 steps of the jitted JAX seg step and of the port's from the same
    weights on the same batches (RandAugment, dropout and drop-path off; the
    JAX attention and histogram through their Pallas kernels in interpret
    mode); built once per module."""
    rng = np.random.default_rng(0)
    fmodel, variables, tmodel = _segmentors(rng)
    batches = [_seg_batch(rng, B=3) for _ in range(3)]
    lr, wd, decay, depth = 1e-3, 0.05, 0.65, 2
    lr_fn = poly_lr_schedule(lr, 3, warmup_iters=2)
    opt = optim.create_optimizer(tmodel, lr, wd, layer_decay=decay, num_layers=depth,
                                 betas=cli.SEG_BETAS)
    tstep, teval = make_seg_steps(tmodel, opt, lr_fn, wd, NUM_CLASSES, False, y_sorted=True)
    got = []
    for t, b in enumerate(batches):
        tb = _as_torch(b)
        tb.pop("aug_seed")
        got.append({k: v.item() for k, v in tstep(tb, t).items()})
    got_cm = teval({k: v for k, v in _as_torch(batches[0]).items()
                    if k in ("events_xyp", "n_valid", "label")}).numpy()

    params, stats = variables["params"], variables["batch_stats"]
    wrapped = {"params": params}
    tx = jax_optim.scheduled_adamw(
        jax_train_seg.poly_lr_schedule(lr, 3, warmup_iters=2), (lambda s: wd),
        jax_optim.build_lr_scale_tree(wrapped, decay, depth)["params"],
        jax_optim.build_wd_mask_tree(wrapped)["params"], b1=0.9, b2=0.999, eps=1e-8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_attention, "ENABLED", True)
        mp.setattr(jax_voxelize, "PALLAS_HIST", True)
        jstep, jeval = jax_train_seg.make_seg_steps(fmodel, tx, NUM_CLASSES, False,
                                                    y_sorted=True)
        state, want = tx.init(params), []
        for b in batches:
            params, stats, state, m = jstep(params, stats, state, jax.tree.map(jnp.asarray, b),
                                            jax.random.key(0))
            want.append({k: float(v) for k, v in m.items()})
        want_cm = np.asarray(jeval(params, stats, {
            k: jnp.asarray(v) for k, v in batches[0].items()
            if k in ("events_xyp", "n_valid", "label")}))
    want_sd = seg_from_jax_params(jax.device_get({"params": params, "batch_stats": stats}))
    return got, want, tmodel, want_sd, got_cm, want_cm


def test_three_seg_steps_metrics_match_jax(three_seg_steps):
    """f32 both sides: the loss and the grad norm to 1e-4 relative."""
    got, want, *_ = three_seg_steps
    for t, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4, err_msg=f"step {t}")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4,
                                   err_msg=f"step {t}")
    assert got[0]["loss"] > 0 and got[0]["grad_norm"] > 0


def test_three_seg_steps_params_and_buffers_match_jax(three_seg_steps):
    """Parameters and BatchNorm buffers after 3 steps. Adam divides each
    gradient by its own running RMS, so a component whose gradient is ~0 on
    both sides (the bias of a convolution that feeds a BatchNorm) moves by up
    to +-lr per step in either direction: atol 2 * (1e-9 + 5e-4 + 3.4e-4)
    covers that, and 99% of the elements must agree to 1e-4 of their scale."""
    _, _, tmodel, want, *_ = three_seg_steps
    n_all = n_close = 0
    for name, p in tmodel.state_dict().items():
        w = want[name].numpy()
        d = np.abs(p.detach().numpy() - w)
        if "running_" in name:
            assert d.max() <= 1e-4 * max(1.0, np.abs(w).max()), (name, d.max())
            continue
        assert d.max() <= 1.7e-3, (name, d.max())
        n_all += d.size
        n_close += int((d <= 1e-4 * np.maximum(1.0, np.abs(w))).sum())
    assert n_close / n_all >= 0.99, n_close / n_all


def test_seg_eval_step_confusion_matrix_matches_jax(three_seg_steps):
    """The eval step on the trained weights: at most 1e-3 of the pixels fall
    into another cell (near-tie argmax flips)."""
    *_, got_cm, want_cm = three_seg_steps
    assert got_cm.shape == (NUM_CLASSES, NUM_CLASSES)
    assert got_cm.sum() == want_cm.sum() == 3 * 430 * 640
    assert np.abs(got_cm - want_cm).sum() <= 2e-3 * want_cm.sum()


# -- surgery --------------------------------------------------------------------

def test_surgery_for_finetune_equals_jax():
    """A pretraining checkpoint (one shared 4x4-window table, mask_token,
    lm_head) onto the segmentation backbone at an 8x8 window: the port's
    surgery on state_dicts gives exactly what the JAX package's gives on the
    flax trees."""
    rng = np.random.default_rng(2)
    pt = jax_create_model("pt_vit", dtype=jnp.float32, img_size=(64, 64), patch_size=(16, 16),
                          in_chans=3, vocab_size=32, embed_dim=32, depth=2, num_heads=2,
                          init_values=0.1, use_shared_rel_pos_bias=True)
    src = _redraw(jax.jit(pt.init)(jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
                                   jnp.zeros((1, 16), bool)), rng)
    src = jax.tree.map(lambda a: np.asarray(rng.standard_normal(a.shape), np.float32), src)
    fmodel = jseg.EncoderDecoder(num_classes=NUM_CLASSES, dtype=jnp.float32,
                                 backbone_cfg=dict(_BACKBONE, img_size=128), **_HEADS)
    variables = jax.device_get(jax.jit(fmodel.init)(jax.random.key(1),
                                                    jnp.zeros((1, 44, 64, 3))))
    merged = jax_surgery.surgery_for_finetune(
        src, {"params": variables["params"]["backbone"]}, dst_window=(8, 8))
    want = seg_from_jax_params({"params": {**variables["params"], "backbone": merged["params"]},
                                "batch_stats": variables["batch_stats"]})
    template = {k[len("backbone."):]: v.numpy()
                for k, v in seg_from_jax_params(variables).items() if k.startswith("backbone.")}
    got = surgery.surgery_for_finetune(
        {k: v.numpy() for k, v in from_jax_params(src).items()}, template, (8, 8))
    assert set(got) == set(template)
    changed = 0
    for k, v in got.items():
        np.testing.assert_array_equal(v, want["backbone." + k].numpy(), err_msg=k)
        changed += int(not np.array_equal(v, template[k]))
    assert got["blocks.1.attn.relative_position_bias_table"].shape == (15 * 15 + 3, 2)
    assert changed >= 20 and "mask_token" not in got and "lm_head.weight" not in got


def test_interpolations_equal_jax(rng):
    table = rng.standard_normal((27 * 27 + 3, 4)).astype(np.float32)
    np.testing.assert_array_equal(surgery.interpolate_rel_pos_bias(table, 27, 63),
                                  jax_surgery.interpolate_rel_pos_bias(table, 27, 63))
    pos = rng.standard_normal((1, 1 + 14 * 14, 8)).astype(np.float32)
    np.testing.assert_array_equal(surgery.interpolate_abs_pos_embed(pos, 32),
                                  jax_surgery.interpolate_abs_pos_embed(pos, 32))


# -- the CLI on the CPU --------------------------------------------------------

_SIZE = ["--num_classes", "3", "--seg_input_size", "64", "--embed_dim", "32", "--depth", "2",
         "--num_heads", "2", "--slice_max_evs", "25000", "--dtype", "float32", "--device", "cpu"]


@pytest.fixture(scope="module")
def synth_seg_dataset(tmp_path_factory):
    """(events .npy, label .png) pairs, 20,000-30,000 events a recording (the
    hot-pixel filter zeroes sparser windows), labels in 40-pixel blocks."""
    from PIL import Image

    root = tmp_path_factory.mktemp("dsec")
    rng = np.random.default_rng(5)
    for split, n in (("train", 6), ("val", 3)):
        (root / "imgs" / split / "seq0").mkdir(parents=True)
        (root / "anns" / split / "seq0").mkdir(parents=True)
        for i in range(n):
            ne = int(rng.integers(20000, 30000))
            ev = np.zeros((ne, 4), np.float32)
            ev[:, 0] = rng.integers(0, 640, ne)
            ev[:, 1] = rng.integers(0, 480, ne)
            ev[: ne // 2, 0] = np.clip(rng.normal(200 + 60 * i, 60, ne // 2), 0, 639).astype(int)
            ev[:, 3] = rng.integers(0, 2, ne)
            np.save(root / "imgs" / split / "seq0" / f"{i:06d}.npy", ev)
            lab = np.repeat(np.repeat(rng.integers(0, 3, (11, 16)), 40, 0), 40, 1).astype(np.uint8)
            lab[:10] = 255
            Image.fromarray(lab).save(root / "anns" / split / "seq0" / f"{i:06d}.png")
    return str(root)


def test_cli_trains_evaluates_saves_and_resumes(synth_seg_dataset, tmp_path, capsys):
    """4 iterations with an evaluation and a checkpoint every 2 and sample
    panels, a second call that auto-resumes at iteration 4 and runs 2 more,
    then test_seg reads the final checkpoint."""
    out = str(tmp_path / "out")
    common = ["--data_root", synth_seg_dataset, *_SIZE, "--batch_size", "2", "--output_dir", out,
              "--eval_interval", "2", "--save_interval", "2", "--warmup_iters", "2",
              "--num_workers", "1"]
    hist = cli.main(common + ["--max_iters", "4", "--dump_samples_dir", str(tmp_path / "dump"),
                              "--dump_samples_n", "3"])
    text = capsys.readouterr().out
    assert [h[0] for h in hist] == [0] and all(np.isfinite(h[1:]).all() for h in hist)
    assert {"checkpoint-1.pth", "checkpoint-3.pth", "checkpoint-final.pth"} \
        <= set(os.listdir(out))
    assert text.count("* iter ") == 2 and "final mIoU" in text and "segmentor params" in text
    assert len(os.listdir(tmp_path / "dump")) == 3
    ck = load_checkpoint(os.path.join(out, "checkpoint-3.pth"))
    assert ck["epoch"] == 4 and "optimizer" in ck
    assert any("running_var" in k for k in ck["model"])
    state = ck["optimizer"]["state"]
    assert all(int(s["step"]) == 4 for s in state.values())
    final = load_checkpoint(os.path.join(out, "checkpoint-final.pth"))
    assert final["epoch"] == 4 and "optimizer" not in final

    resumed = cli.main(common + ["--max_iters", "6"])
    text = capsys.readouterr().out
    assert "Auto-resumed from" in text and "(iter 4)" in text
    assert [h[0] for h in resumed] == [4]
    ck5 = load_checkpoint(os.path.join(out, "checkpoint-5.pth"))
    assert ck5["epoch"] == 6
    assert all(int(s["step"]) == 6 for s in ck5["optimizer"]["state"].values())
    assert not torch.equal(ck5["model"]["decode_head.conv_seg.weight"],
                           ck["model"]["decode_head.conv_seg.weight"])

    stats = test_seg_cli.main(["--data_root", synth_seg_dataset, *_SIZE, "--checkpoint",
                               os.path.join(out, "checkpoint-final.pth")])
    assert 0.0 <= stats["mIoU"] <= 1.0


def test_cli_pretrained_runs_the_surgery(synth_seg_dataset, tmp_path, capsys):
    """A pretraining-schema .pth (shared table at a 14x14 window, mask_token,
    lm_head) under a ``module.`` prefix initialises the backbone: every
    block's table is the interpolated shared one."""
    from mem_tpu_torch.models.registry import create_model

    pt = create_model("pt_vit", img_size=(224, 224), patch_size=(16, 16), in_chans=3,
                      vocab_size=16, embed_dim=32, depth=2, num_heads=2, init_values=0.1,
                      use_shared_rel_pos_bias=True)
    pt.init_weights(torch.Generator().manual_seed(4))
    with torch.no_grad():
        pt.rel_pos_bias.relative_position_bias_table.normal_(
            generator=torch.Generator().manual_seed(5))
    path = str(tmp_path / "pt.pth")
    torch.save({"model": {"module." + k: v for k, v in pt.state_dict().items()}}, path)
    out = str(tmp_path / "out")
    cli.main(["--data_root", synth_seg_dataset, *_SIZE, "--batch_size", "2", "--output_dir", out,
              "--max_iters", "0", "--pretrained", path, "--num_workers", "1"])
    assert "backbone initialized from" in capsys.readouterr().out
    sd = load_checkpoint(os.path.join(out, "checkpoint-final.pth"))["model"]
    want = surgery.interpolate_rel_pos_bias(
        pt.rel_pos_bias.relative_position_bias_table.detach().numpy(), 27, 7)
    for b in range(2):
        np.testing.assert_array_equal(
            sd[f"backbone.blocks.{b}.attn.relative_position_bias_table"].numpy(), want)
    assert torch.equal(sd["backbone.blocks.0.attn.qkv.weight"],
                       pt.state_dict()["blocks.0.attn.qkv.weight"])


@pytest.mark.parametrize("pretrained,exc,match", [
    ("weights.npz", FileNotFoundError, "weights.npz"),
    ("orbax_dir", ValueError, "export_torch"),
    ("PT21k", SystemExit, "timm hub"),
])
def test_cli_pretrained_formats_that_raise(synth_seg_dataset, tmp_path, pretrained, exc, match):
    with pytest.raises(exc, match=match):
        cli.main(["--data_root", synth_seg_dataset, *_SIZE, "--batch_size", "2",
                  "--output_dir", str(tmp_path / "out"), "--max_iters", "1",
                  "--pretrained", pretrained, "--num_workers", "1"])


def test_cli_device_cuda_without_card_raises(synth_seg_dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--data_root", synth_seg_dataset, "--output_dir", str(tmp_path / "out"),
                  "--max_iters", "1"])
