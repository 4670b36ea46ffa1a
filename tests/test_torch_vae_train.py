"""VAE training in the port held against the JAX package: the decoder's
ConvTranspose2d(4, 2, 1) against the flax ``TorchConvTranspose`` (forward
and its custom VJP), the event VAE's training loss and gradients with
injected Gumbel noise, ``decode_indices``, the legacy VAE, three
``make_vae_train_step`` steps and the eval step against the jitted JAX
steps, ``VaeAnnealState``, the reconstruction panels and the grad-norm
trigger, and the ``train_vae`` CLI on the CPU (flags, resume, the .pth that
pretraining loads, pretraining's ``--dump_recon_dir``). Sizes: 32 tokens, a
codebook of 8, 2 layers, 1 ResBlock, hidden 16, 32x32 inputs; f32 on both
sides."""
import glob
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import mem_tpu.ops.voxelize as jax_voxelize
from mem_tpu.cli import run_mem_pretraining as jax_pretraining
from mem_tpu.cli import train_vae as jax_train_vae
from mem_tpu.data.device_pipeline import PreprocConfig as JaxPreprocConfig
from mem_tpu.data.device_pipeline import preprocess_batch as jax_preprocess_batch
from mem_tpu.models.discrete_vae import DiscreteVAE as JaxDiscreteVAE
from mem_tpu.models.discrete_vae import LegacyDiscreteVAE as JaxLegacyVAE
from mem_tpu.models.discrete_vae import TorchConvTranspose as JaxConvTranspose
from mem_tpu.train import schedules as jax_schedules
from mem_tpu.train.steps import make_vae_eval_step as jax_make_eval_step
from mem_tpu.train.steps import make_vae_train_step as jax_make_train_step
from mem_tpu.utils import visualize as jax_visualize
from mem_tpu.utils.torch_import import import_legacy_vae_state_dict
from mem_tpu_torch.data.device_pipeline import PreprocConfig
from mem_tpu_torch.models.discrete_vae import ConvTranspose2d, DiscreteVAE, LegacyDiscreteVAE
from mem_tpu_torch.models.registry import create_model
from mem_tpu_torch.train.schedules import VaeAnnealState
from mem_tpu_torch.train.steps import make_vae_eval_step, make_vae_train_step
from mem_tpu_torch.utils import visualize
from mem_tpu_torch.utils.weights import legacy_vae_from_jax_params, vae_from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_KW = dict(num_tokens=32, codebook_dim=8, num_layers=2, hidden_dim=16, num_resnet_blocks=1)
TOL = 1e-5        # f32 on both sides: the same sums in another order
GRAD_TOL = 1e-4   # a gradient relative L2: a bias's gradient sums a whole batch of
                  # pixels, whose terms cancel (1.2e-5 seen on the smooth-L1 head bias)


def _redraw(rng, tree):
    """Non-zero biases, He-scaled kernels (logits O(1), many tokens)."""
    def one(leaf):
        if leaf.ndim == 1:
            return jnp.asarray(0.1 * rng.standard_normal(leaf.shape), jnp.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return jnp.asarray(rng.standard_normal(leaf.shape) * np.sqrt(2.0 / fan_in), jnp.float32)

    return jax.device_get(jax.tree.map(one, tree))


def _vae_pair(rng, **kw):
    fvae = JaxDiscreteVAE(input_hw=(32, 32), **{**_KW, **kw})
    variables = _redraw(rng, jax.jit(fvae.init)(
        {"params": jax.random.key(0), "gumbel": jax.random.key(1)},
        jnp.zeros((1, 32, 32, 3)), 1.0))
    tvae = DiscreteVAE((32, 32), **{**_KW, **kw})
    tvae.load_state_dict(vae_from_jax_params(variables), strict=True)
    return fvae, variables, tvae


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _assert_grads(tvae, jax_grads, from_jax, tol):
    want = from_jax(jax.device_get(jax_grads))
    got = dict(tvae.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        assert _rel(got[name].grad.numpy(), w.numpy()) <= tol, name


# -- the transposed convolution ---------------------------------------------

def test_conv_transpose_421_matches_flax_and_its_vjp(rng):
    """The decoder's ConvTranspose2d(4, 2, 1) on NHWC views against the
    flax TorchConvTranspose (its dilated forward and hand-derived custom
    VJP): the output, the input gradient and the kernel and bias gradients,
    f32 to 1e-5 relative L2."""
    x = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)
    layer = JaxConvTranspose(4)
    params = _redraw(rng, layer.init(jax.random.key(0), jnp.asarray(x)))
    y, vjp = jax.vjp(lambda p, xx: layer.apply(p, xx), params, jnp.asarray(x))
    dy = rng.standard_normal(y.shape).astype(np.float32)
    dp, dx = vjp(jnp.asarray(dy))

    conv = ConvTranspose2d(6, 4, 4, stride=2, padding=1)
    with torch.no_grad():
        conv.weight.copy_(torch.tensor(np.transpose(params["params"]["kernel"], (2, 3, 0, 1))))
        conv.bias.copy_(torch.tensor(np.asarray(params["params"]["bias"])))
    xt = torch.from_numpy(x).requires_grad_()
    yt = conv(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    yt.backward(torch.from_numpy(dy))
    assert yt.shape == (2, 10, 14, 4)
    assert _rel(yt.detach().numpy(), y) <= TOL
    assert _rel(xt.grad.numpy(), dx) <= TOL
    assert _rel(conv.weight.grad.numpy(),
                np.transpose(np.asarray(dp["params"]["kernel"]), (2, 3, 0, 1))) <= TOL
    assert _rel(conv.bias.grad.numpy(), dp["params"]["bias"]) <= TOL


# -- the event VAE -----------------------------------------------------------

@pytest.mark.parametrize("loss_type", ["mse", "smooth_l1", "cosine"])
@pytest.mark.parametrize("straight_through", [False, True])
@pytest.mark.parametrize("normalization", [None, ((0.1, 0.2, 0.3), (0.5, 0.6, 0.7))])
def test_vae_loss_and_grads_match_flax(rng, loss_type, straight_through, normalization):
    """The training forward with injected noise, kl weight 1e-3 so the KL
    term (summed, not divided by B) counts: loss and reconstruction to 1e-5,
    every parameter's gradient to GRAD_TOL relative L2."""
    kw = dict(loss_type=loss_type, straight_through=straight_through,
              kl_div_loss_weight=1e-3, normalization=normalization)
    fvae, variables, tvae = _vae_pair(rng, **kw)
    img = rng.random((3, 32, 32, 3)).astype(np.float32)
    noise = rng.gumbel(size=(3, 8, 8, 32)).astype(np.float32)
    (loss, out), grads = jax.value_and_grad(
        lambda p: fvae.apply(p, jnp.asarray(img), 0.7, gumbel_noise=jnp.asarray(noise),
                             return_recons=True), has_aux=True)(variables)
    got, rec = tvae(torch.from_numpy(img), 0.7, gumbel_noise=torch.from_numpy(noise),
                    return_recons=True)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=TOL)
    assert _rel(rec.detach().numpy(), out) <= TOL
    _assert_grads(tvae, grads, vae_from_jax_params, GRAD_TOL)


def test_kl_is_summed_over_the_batch(rng):
    """The batchmean quirk: the KL term doubles when the batch is repeated,
    where the reconstruction loss (a mean) stays."""
    _, _, tvae = _vae_pair(rng)
    img = torch.from_numpy(rng.random((2, 32, 32, 3)).astype(np.float32))
    noise = torch.from_numpy(rng.gumbel(size=(2, 8, 8, 32)).astype(np.float32))
    kl = {}
    with torch.no_grad():
        for reps in (1, 2):
            x, g = torch.cat([img] * reps), torch.cat([noise] * reps)
            tvae.kl_div_loss_weight = 0.0
            recon = tvae(x, 1.0, gumbel_noise=g).item()
            tvae.kl_div_loss_weight = 1.0
            kl[reps] = tvae(x, 1.0, gumbel_noise=g).item() - recon
    assert kl[1] > 0 and kl[2] == pytest.approx(2 * kl[1], rel=1e-5)


def test_decode_indices_and_indices_match_flax(rng):
    fvae, variables, tvae = _vae_pair(rng)
    img = rng.random((3, 32, 32, 3)).astype(np.float32)
    ids = np.asarray(fvae.apply(variables, jnp.asarray(img), method="get_codebook_indices"))
    want = np.asarray(fvae.apply(variables, jnp.asarray(ids), method="decode_indices"))
    with torch.no_grad():
        got_ids = tvae.get_codebook_indices(torch.from_numpy(img)).numpy()
        got = tvae.decode_indices(torch.from_numpy(ids.astype(np.int64))).numpy()
    assert got.shape == want.shape == (3, 32, 32, 3) and len(np.unique(ids)) > 4
    assert (got_ids == ids).mean() > 0.95
    assert _rel(got, want) <= TOL


def test_bf16_compute_keeps_f32_params(rng):
    """dtype=bfloat16: parameters and their gradients stay f32, the
    reconstruction comes out in bf16, the loss in f32 near the f32 loss."""
    _, variables, t32 = _vae_pair(rng)
    t16 = DiscreteVAE((32, 32), dtype=torch.bfloat16, **_KW)
    t16.load_state_dict(vae_from_jax_params(variables), strict=True)
    img = torch.from_numpy(rng.random((2, 32, 32, 3)).astype(np.float32))
    noise = torch.from_numpy(rng.gumbel(size=(2, 8, 8, 32)).astype(np.float32))
    loss, rec = t16(img, 1.0, gumbel_noise=noise, return_recons=True)
    loss.backward()
    assert loss.dtype == torch.float32 and rec.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in t16.parameters())
    np.testing.assert_allclose(loss.item(), t32(img, 1.0, gumbel_noise=noise).item(), rtol=5e-2)


def test_gumbel_draws_follow_the_generator(rng):
    _, _, tvae = _vae_pair(rng)
    img = torch.from_numpy(rng.random((2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        a, b, c = (tvae(img, 1.0, generator=torch.Generator().manual_seed(s)) for s in (3, 3, 4))
    assert a.item() == b.item() != c.item()


def test_init_weights_decoder_defaults():
    """The decoder's convs lecun-normal, its ConvTranspose2d kernels
    U(+-1/sqrt(O k k)) (flax variance_scaling(1/3, fan_in, uniform) over the
    output features), every bias zero."""
    vae = create_model("event_vae", input_hw=(32, 32), **_KW)
    vae.init_weights(torch.Generator().manual_seed(0))
    for name, p in vae.decoder.named_parameters():
        if name.endswith("bias"):
            assert not p.any(), name
        elif name.endswith(".0.weight") and p.shape[-1] == 4:
            lim = p[0].numel() ** -0.5
            assert p.abs().max().item() <= lim and p.abs().max().item() > 0.9 * lim, name
        else:
            assert abs(p.std().item() * p[0].numel() ** 0.5 - 1.0) < 0.3, name


# -- the legacy VAE ----------------------------------------------------------

def _legacy_pair(rng, **kw):
    fvae = JaxLegacyVAE(image_size=16, num_tokens=32, codebook_dim=8, num_layers=2,
                        hidden_dim=16, kl_div_loss_weight=1e-3, **kw)
    variables = _redraw(rng, jax.jit(fvae.init)(
        {"params": jax.random.key(0), "gumbel": jax.random.key(1)}, jnp.zeros((1, 16, 16, 3))))
    sd = legacy_vae_from_jax_params(variables)
    tvae = LegacyDiscreteVAE(image_size=16, num_tokens=32, codebook_dim=8, num_layers=2,
                             hidden_dim=16, kl_div_loss_weight=1e-3, **kw)
    tvae.load_state_dict(sd, strict=True)
    return fvae, variables, tvae, sd


def test_legacy_weights_round_trip(rng):
    _, variables, _, sd = _legacy_pair(rng)
    back = import_legacy_vae_state_dict(sd, num_layers=2)
    want = jax.tree_util.tree_flatten_with_path(variables)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("smooth_l1,straight_through",
                         [(False, False), (True, False), (False, True)])
def test_legacy_loss_and_grads_match_flax(rng, smooth_l1, straight_through):
    fvae, variables, tvae, _ = _legacy_pair(rng, smooth_l1_loss=smooth_l1,
                                            straight_through=straight_through)
    img = rng.random((2, 16, 16, 3)).astype(np.float32)
    noise = rng.gumbel(size=(2, 4, 4, 32)).astype(np.float32)
    loss, grads = jax.value_and_grad(lambda p: fvae.apply(
        p, jnp.asarray(img), temp=0.7, gumbel_noise=jnp.asarray(noise)))(variables)
    got = tvae(torch.from_numpy(img), temp=0.7, gumbel_noise=torch.from_numpy(noise))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=TOL)
    _assert_grads(tvae, grads, legacy_vae_from_jax_params, GRAD_TOL)


def test_legacy_indices_probs_decode_and_quirks(rng):
    fvae, variables, tvae, _ = _legacy_pair(rng)
    img = rng.random((2, 16, 16, 3)).astype(np.float32)
    ids = np.asarray(fvae.apply(variables, jnp.asarray(img), method="get_codebook_indices"))
    probs = np.asarray(fvae.apply(variables, jnp.asarray(img), method="get_codebook_probs"))
    flat = rng.integers(0, 32, size=(2, 16))
    want = np.asarray(fvae.apply(variables, jnp.asarray(flat), method="decode_indices"))
    with torch.no_grad():
        got_ids = tvae.get_codebook_indices(torch.from_numpy(img)).numpy()
        got_probs = tvae.get_codebook_probs(torch.from_numpy(img)).numpy()
        got = tvae.decode_indices(torch.from_numpy(flat)).numpy()
    assert got_ids.shape == ids.shape == (2, 4, 4)     # unflattened
    np.testing.assert_array_equal(got_ids, ids)
    np.testing.assert_allclose(got_probs, probs, atol=2e-6)
    assert got.shape == (2, 16, 16, 3) and _rel(got, want) <= TOL
    m = LegacyDiscreteVAE(image_size=64, num_layers=2)
    assert m.get_image_tokens_size() == 8 and m.get_image_size() == 64
    with pytest.raises(ValueError, match="correct image size"):
        tvae(torch.zeros(1, 32, 32, 3))


# -- the anneal and the steps --------------------------------------------------

def test_vae_anneal_matches_reference_over_25k_steps():
    """Epochs of 12,000 steps: the lr and temperature change after steps 0
    and 10,000 of each epoch; both states agree at every step."""
    kw = dict(base_lr=2e-4, lr_decay=0.99, starting_temp=1.0, anneal_rate=1e-6, temp_min=0.5)
    got, want = VaeAnnealState(**kw), jax_schedules.VaeAnnealState(**kw)
    changes = 0
    for step in range(25_000):
        before = got.lr
        got.after_step(step % 12_000)
        want.after_step(step % 12_000)
        assert (got.lr, got.temp, got.global_step) == (want.lr, want.temp, want.global_step)
        changes += got.lr != before
    assert changes == 5 and got.temp < 1.0


def _batches(rng, n, B=4, N=1200):
    out = []
    for _ in range(n):
        ev = np.zeros((B, N, 4), np.float32)
        ev[..., 0] = rng.integers(0, 48, (B, N))
        ev[..., 1] = rng.integers(0, 40, (B, N))
        ev[..., 2] = np.sort(rng.integers(0, 10**6, (B, N)), axis=1)
        ev[..., 3] = rng.choice([-1.0, 1.0], (B, N))
        out.append({"events": ev, "n_valid": np.array([N, 900, 300, N], np.int32),
                    "sample_h": np.array([40, 33, 40, 28], np.int32),
                    "sample_w": np.array([48, 40, 31, 48], np.int32),
                    "time_flip": rng.random(B) < 0.5, "x_flip": rng.random(B) < 0.5,
                    "shift_xy": rng.integers(-2, 3, (B, 2)).astype(np.int32),
                    "aug_seed": np.arange(B, dtype=np.uint32)})
    return out


_PP = dict(input_h=32, input_w=32, canvas_h=48, canvas_w=48, rand_aug=False, color_jitter=0.0)
CLIP = 1e-2       # the conf's vae_grad_clip: the clip is active at every step


@pytest.fixture(scope="module")
def three_steps():
    """Three steps of the jitted JAX VAE step (inject_noise, optax
    scale_by_adam, the histogram through its Pallas kernel in interpret
    mode) and of the port's from the same weights, batches and noise, the lr
    and temperature of one shared VaeAnnealState (changing after every
    step); and the JAX gradients of step 1, clipped as the step clips."""
    rng = np.random.default_rng(0)
    fvae, variables, tvae = _vae_pair(rng, kl_div_loss_weight=1e-3)
    batches = _batches(rng, 3)
    noises = [rng.gumbel(size=(4, 8, 8, 32)).astype(np.float32) for _ in range(3)]
    sched = VaeAnnealState(1e-3, 0.5, starting_temp=1.0, anneal_rate=0.2, temp_min=0.5, every=1)
    lrs, temps = [], []
    for i in range(3):
        lrs.append(sched.lr)
        temps.append(sched.temp)
        sched.after_step(i)

    opt = torch.optim.Adam(tvae.parameters(), lr=1.0, betas=(0.9, 0.999), eps=1e-8)
    tstep = make_vae_train_step(tvae, opt, PreprocConfig(**_PP), CLIP, inject_noise=True)
    got, grads1 = [], None
    for b, g, lr, temp in zip(batches, noises, lrs, temps):
        m = tstep({k: torch.from_numpy(v) for k, v in b.items()}, torch.from_numpy(g), lr, temp)
        got.append({k: v.item() for k, v in m.items()})
        if grads1 is None:
            grads1 = {n: p.grad.clone() for n, p in tvae.named_parameters()}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_voxelize, "PALLAS_HIST", True)
        tx = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
        jstep = jax_make_train_step(fvae, tx, JaxPreprocConfig(**_PP), inject_noise=True)
        params, state, want = variables, tx.init(variables), []
        for b, g, lr, temp in zip(batches, noises, lrs, temps):
            params, state, m = jstep(params, state, jax.tree.map(jnp.asarray, b),
                                     jnp.asarray(g), jnp.float32(lr), jnp.float32(temp),
                                     jnp.float32(CLIP))
            want.append({k: float(v) for k, v in m.items()})
        images = jax_preprocess_batch(jax.tree.map(jnp.asarray, batches[0]),
                                      JaxPreprocConfig(**_PP), True)
        jgrads = jax.grad(lambda p: fvae.apply(p, images, temps[0],
                                               gumbel_noise=jnp.asarray(noises[0])))(variables)
    factor = min(1.0, CLIP / (want[0]["grad_norm"] + 1e-6))
    return got, want, grads1, vae_from_jax_params(jax.device_get(jgrads)), factor


def test_three_vae_steps_match_jax(three_steps):
    """Loss and pre-clip grad norm of each step to 1e-4 relative (sums in
    another order over the preprocessing, the VAE and two Adam updates);
    the clipped gradients of step 1 to 1e-4 relative L2."""
    got, want, grads1, jgrads, factor = three_steps
    assert factor < 1.0
    for t, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4, err_msg=f"step {t}")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4,
                                   err_msg=f"step {t}")
    assert got[1]["loss"] != got[0]["loss"]
    for name, w in jgrads.items():
        assert _rel(grads1[name].numpy(), factor * w.numpy()) <= 1e-4, name


def test_vae_eval_step_matches_jax(rng):
    """The eval step: the ids (all but near-ties), the reconstruction and
    the MSE against the unnormalized images, f32 to 1e-5."""
    fvae, variables, tvae = _vae_pair(rng)
    batch = _batches(rng, 1)[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_voxelize, "PALLAS_HIST", True)
        want = jax_make_eval_step(fvae, JaxPreprocConfig(**_PP))(
            variables, jax.tree.map(jnp.asarray, batch))
    got = make_vae_eval_step(tvae, PreprocConfig(**_PP))(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert _rel(got["images"].numpy(), want["images"]) <= TOL
    np.testing.assert_array_equal(got["ids"].numpy(), np.asarray(want["ids"]))
    assert _rel(got["recon"].numpy(), want["recon"]) <= TOL
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=TOL)


# -- the panels and the dump trigger -------------------------------------------

def test_panels_equal_the_reference_s(rng):
    imgs = rng.random((3, 32, 32, 3)).astype(np.float32)
    recon = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    mask = rng.random((3, 16)) < 0.4
    np.testing.assert_array_equal(visualize.reconstruction_panel(imgs, recon),
                                  jax_visualize.reconstruction_panel(imgs, recon))
    for i in range(3):
        np.testing.assert_array_equal(visualize.mask_overlay(imgs[i], mask[i], 8),
                                      jax_visualize.mask_overlay(imgs[i], mask[i], 8))


@pytest.mark.parametrize("args", [(7.0, 1000, -10**9, 6.0), (5.0, 1000, -10**9, 6.0),
                                  (float("nan"), 1000, -10**9, 6.0), (float("inf"), 50, 0, 6.0),
                                  (7.0, 150, 0, 6.0), (7.0, 99, 0, 6.0)])
def test_dump_trigger_is_the_reference_s(args):
    from mem_tpu_torch.cli.run_mem_pretraining import should_dump_on_grad_norm

    assert should_dump_on_grad_norm(*args) == jax_pretraining.should_dump_on_grad_norm(*args)


# -- the CLI on the CPU ----------------------------------------------------------

def test_cli_flags_are_the_reference_s():
    """Every flag of the reference's parser binds in the port's, with the
    same defaults (plus ``--device``); the conf's vae_* keys bind."""
    from mem_tpu_torch.cli import train_vae as T

    for argv in (["--data_path", "x"],
                 ["--data_path", "x", "--config", os.path.join(REPO, "configs", "ncaltech.conf")]):
        want, got = vars(jax_train_vae.get_args(argv)), vars(T.get_args(argv))
        assert set(got) - set(want) == {"device"}, sorted(set(got) ^ set(want))
        assert {k for k in want if want[k] != got[k]} == set()
    conf = T.get_args(["--config", os.path.join(REPO, "configs", "ncaltech.conf")])
    assert (conf.batch_size, conf.clip, conf.hidden_dim, conf.device) == (192, 1e-2, 384, "cuda")


def _write_events(root, rng):
    for split, n in (("train", 12), ("val", 4)):
        for i in range(n):
            d = root / split / f"c{i % 2}"
            d.mkdir(parents=True, exist_ok=True)
            m = int(rng.integers(300, 2000))
            ev = np.zeros((m, 4))
            ev[:, 0] = rng.integers(0, 30, m)
            ev[:, 1] = rng.integers(0, 24, m)
            ev[:, 2] = np.sort(rng.integers(0, 10**5, m))
            ev[:, 3] = rng.choice([-1.0, 1.0], m)
            np.save(d / f"s{i}.npy", ev)


def _vae_flags(tmp_path, root):
    return ["--config", os.path.join(REPO, "configs", "ncaltech.conf"), "--data_path", root,
            "--output_dir", str(tmp_path / "vae_out"), "--device", "cpu", "--dtype", "float32",
            "--input_H", "32", "--input_W", "32", "--num_layers", "2", "--num_tokens", "32",
            "--emb_dim", "8", "--hidden_dim", "16", "--num_resnet_blocks", "1",
            "--batch_size", "4", "--num_workers", "0", "--slice_max_evs", "1500",
            "--max_random_shift_evs", "2", "--eval_freq", "1", "--save_ckpt_freq", "1",
            "--dump_recon_dir", str(tmp_path / "recon")]


def test_train_vae_cli_resumes_and_feeds_pretraining(tmp_path, capsys):
    """train_vae on the CPU: 2 epochs with evals, panels and checkpoints,
    an auto-resumed third epoch (params, Adam state, lr, temp and step
    restored), a checkpoint-final.pth that run_mem_pretraining loads as it
    is, whose --dump_recon_dir then writes its eval and triggered panels."""
    from mem_tpu_torch.cli import run_mem_pretraining as P
    from mem_tpu_torch.cli import train_vae as T

    rng = np.random.default_rng(0)
    root = tmp_path / "ncaltech101"
    _write_events(root, rng)
    flags = _vae_flags(tmp_path, str(root))
    hist = T.main(flags + ["--epochs", "2"])
    out = capsys.readouterr().out
    assert [h[0] for h in hist] == [0, 1, 2, 3, 4, 5]
    assert all(np.isfinite(h[1]) and np.isfinite(h[2]) for h in hist)
    assert out.count("codebook usage ") == 2 and "/32" in out
    vae_out = tmp_path / "vae_out"
    assert sorted(os.listdir(vae_out)) == ["checkpoint-0.pth", "checkpoint-1.pth",
                                          "checkpoint-final.pth"]
    assert sorted(os.listdir(tmp_path / "recon")) == ["recon_ep0.png", "recon_ep1.png"]
    ck = torch.load(vae_out / "checkpoint-1.pth", weights_only=True)
    assert ck["global_step"] == 6 and ck["epoch"] == 1
    assert ck["lr"] == pytest.approx(2e-4 * 0.99 ** 2) and ck["hparams"]["channels"] == 3

    resumed = T.main(flags + ["--epochs", "3"])
    assert [h[0] for h in resumed] == [6, 7, 8]
    assert "Auto-resumed from" in capsys.readouterr().out
    final = torch.load(vae_out / "checkpoint-final.pth", weights_only=True)
    assert final["epoch"] == 2 and set(final) == {"model", "epoch", "hparams"}

    dump = tmp_path / "pt_dump"
    P.main(["--config", os.path.join(REPO, "configs", "ncaltech.conf"),
            "--data_path", str(root), "--discrete_vae_weight_path",
            str(vae_out / "checkpoint-final.pth"), "--output_dir", str(tmp_path / "pt"),
            "--device", "cpu", "--input_H", "32", "--input_W", "32", "--num_layers", "2",
            "--transformer_emb", "32", "--transformer_depth", "2", "--transformer_heads", "4",
            "--num_tokens", "32", "--num_mask_patches", "20", "--batch_size", "4",
            "--num_workers", "0", "--max_random_shift_evs", "2", "--slice_max_evs", "1500",
            "--mask_pool_size", "16", "--warmup_steps", "2", "--epochs", "1",
            "--dump_recon_dir", str(dump), "--recon_grad_norm_thresh", "0"])
    names = sorted(os.listdir(dump))
    assert {"recon_ep0.png", "mask_ep0.png"} <= set(names)
    assert glob.glob(str(dump / "recon_trigger_it*.png")), names


def test_train_vae_check_ported_accepts_imnet():
    """--data_set IMNET is ported (the VAE on real images)."""
    from mem_tpu_torch.cli import train_vae as T

    T.check_ported(T.get_args(["--data_path", "x", "--data_set", "IMNET"]))
