"""The IMNET image branches of the port's train and eval steps held against
the jitted JAX steps on image batches through the weight converters (f32,
drop-path 0): pretraining on the two views, the finetune step and the VAE
step through preprocess_image_cls (RandAugment off, const RandomErasing on
the reference's replayed draws), and the eval steps; then the three CLIs end
to end with ``--data_set IMNET --device cpu`` on synthetic JPEGs."""
import functools
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import mem_tpu.ops.attention as jax_attention
from mem_tpu.data.device_pipeline import PreprocConfig as JaxPreprocConfig
from mem_tpu.data.device_pipeline import preprocess_image_cls as jax_preprocess_image_cls
from mem_tpu.models.discrete_vae import DiscreteVAE as JaxDiscreteVAE
from mem_tpu.models.registry import create_model as jax_create_model
from mem_tpu.train import optim as jax_optim
from mem_tpu.train.schedules import as_schedule_fn
from mem_tpu.train import steps as jax_steps
from mem_tpu_torch.data.device_pipeline import PreprocConfig, preprocess_image_cls
from mem_tpu_torch.models.discrete_vae import DiscreteVAE
from mem_tpu_torch.models.registry import create_model
from mem_tpu_torch.ops import image_ops
from mem_tpu_torch.train import optim, steps
from mem_tpu_torch.train.schedules import cosine_scheduler
from mem_tpu_torch.utils.weights import from_jax_params, vae_from_jax_params

B, S = 4, 32
LR = cosine_scheduler(1e-3, 1e-4, 1, 3)
WD = cosine_scheduler(0.05, 0.2, 1, 3)
_VAE = dict(num_tokens=32, codebook_dim=8, num_layers=2, num_resnet_blocks=1, hidden_dim=16)
_AUG = dict(rand_aug=False, reprob=0.5, remode="const")
_PP = dict(input_h=S, input_w=S, rand_aug=False, color_jitter=0.0)


def _redraw(rng, tree, he=False):
    def one(path, leaf):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return jnp.asarray(1.0 + 0.1 * rng.standard_normal(leaf.shape), jnp.float32)
        if he and leaf.ndim > 1:
            fan_in = int(np.prod(leaf.shape[:-1]))
            return jnp.asarray(rng.standard_normal(leaf.shape) * np.sqrt(2 / fan_in), jnp.float32)
        return jnp.asarray(0.1 * rng.standard_normal(leaf.shape), jnp.float32)

    return jax.device_get(jax.tree_util.tree_map_with_path(one, tree))


def _vae_pair(rng, **kw):
    fvae = JaxDiscreteVAE(input_hw=(S, S), **_VAE, **kw)
    variables = _redraw(rng, jax.jit(fvae.init)(
        {"params": jax.random.key(0), "gumbel": jax.random.key(1)}, jnp.zeros((1, S, S, 3)),
        1.0), he=True)
    tvae = DiscreteVAE((S, S), **_VAE, **kw)
    tvae.load_state_dict(vae_from_jax_params(variables), strict=True)
    return fvae, variables, tvae


def _erasing_draws(seeds):
    """The reference's const-erasing draws of preprocess_image_cls (keys
    folded with 2) replayed as the port's er_use / er_box."""
    use, u = [], []
    for s in seeds:
        k_use, key = jax.random.split(jax.random.fold_in(jax.random.key(int(s)), 2))
        use.append(bool(jax.random.uniform(k_use) < _AUG["reprob"]))
        k_area, k_ratio, k_top, k_left, _, _ = jax.random.split(key, 6)
        u.append([float(jax.random.uniform(k_area, (), minval=0.02, maxval=1.0 / 3)),
                  float(jax.random.uniform(k_ratio, (), minval=jnp.log(0.3),
                                           maxval=jnp.log(3.3))),
                  float(jax.random.uniform(k_top)), float(jax.random.uniform(k_left))])
    u = np.asarray(u, np.float32)[:, None]
    return {"er_use": np.array(use),
            "er_box": image_ops.erasing_boxes(S, S, u[..., 0], u[..., 1], u[..., 2], u[..., 3])}


def _image_batches(rng, n, labels=5):
    out = []
    for i in range(n):
        seeds = (np.arange(B) + 10 * i + 5).astype(np.uint32)
        out.append({"image": rng.random((B, S, S, 3)).astype(np.float32), "aug_seed": seeds,
                    "label": rng.integers(0, labels, B).astype(np.int32)})
    return out


def _torch(b, with_draws=True):
    d = dict(b, **(_erasing_draws(b["aug_seed"]) if with_draws else {}))
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def test_erasing_replay_erases_some_samples():
    d = _erasing_draws(np.arange(B) + 5)
    assert d["er_use"].any() and not d["er_use"].all()


# -- pretraining: the two views ------------------------------------------------

_PT = dict(img_size=(S, S), patch_size=(4, 4), in_chans=3, vocab_size=32, embed_dim=32,
           depth=2, num_heads=4, init_values=0.1, use_shared_rel_pos_bias=True,
           num_masked_tokens=20)


def _two_view_batches(rng, n):
    out = []
    for _ in range(n):
        patches = rng.random((B, S, S, 3)).astype(np.float32)
        # the tokenizer's view: the same window, another filter (here a blur)
        vae_view = (0.5 * patches + 0.25 * np.roll(patches, 1, 1)
                    + 0.25 * np.roll(patches, 1, 2)).astype(np.float32)
        mask = np.zeros((B, 64), bool)
        for b in range(B):
            mask[b, rng.choice(64, int(rng.integers(10, 21)), replace=False)] = True
        out.append({"patches": patches, "vae_view": vae_view, "mask": mask})
    return out


def test_pretrain_steps_on_two_views_match_jax(monkeypatch):
    """Three steps from the same weights: loss and grad norm to 1e-4
    relative, mlm_acc up to one flipped argmax; the eval step too. The
    tokenizer labels come from vae_view: the same steps with the views
    swapped give another loss."""
    monkeypatch.setattr(jax_attention, "ENABLED", True)
    rng = np.random.default_rng(0)
    fmodel = jax_create_model("pt_vit", dtype=jnp.float32, **_PT)
    params = _redraw(rng, jax.jit(fmodel.init)(jax.random.key(0), jnp.zeros((1, S, S, 3)),
                                               jnp.zeros((1, 64), bool)))
    fvae, vae_params, tvae = _vae_pair(rng)
    batches = _two_view_batches(rng, 3)

    def port(swap=False):
        tmodel = create_model("pt_vit", **_PT)
        tmodel.load_state_dict(from_jax_params(params), strict=True)
        opt = optim.create_optimizer(tmodel, 1e-3, 0.05)
        step = steps.make_pretrain_train_step(tmodel, tvae, opt, PreprocConfig(**_PP), LR, WD,
                                              1.0)
        out = []
        for t, b in enumerate(batches):
            tb = {k: torch.from_numpy(v) for k, v in b.items()}
            if swap:
                tb["patches"], tb["vae_view"] = tb["vae_view"], tb["patches"]
            out.append({k: v.item() for k, v in step(tb, t).items()})
        return out, tmodel

    got, tmodel = port()
    tx = jax_optim.create_optimizer(params, as_schedule_fn(LR), wd_schedule=as_schedule_fn(WD),
                                    weight_decay=0.05, clip_grad=1.0)
    jstep = jax_steps.make_pretrain_train_step(fmodel, fvae, tx, JaxPreprocConfig(**_PP))
    jp, state, want = params, tx.init(params), []
    for b in batches:
        jp, state, m = jstep(jp, state, vae_params, jax.tree.map(jnp.asarray, b),
                             jax.random.key(0))
        want.append({k: float(v) for k, v in m.items()})
    for t, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4, err_msg=f"step {t}")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4,
                                   err_msg=f"step {t}")
        assert abs(g["mlm_acc"] - w["mlm_acc"]) <= 1 / 40 + 1e-6, t
    swapped, _ = port(swap=True)
    assert abs(swapped[0]["loss"] - got[0]["loss"]) > 1e-3

    want_ev = jax_steps.make_pretrain_eval_step(fmodel, fvae, JaxPreprocConfig(**_PP))(
        jp, vae_params, jax.tree.map(jnp.asarray, batches[0]))
    got_ev = steps.make_pretrain_eval_step(tmodel, tvae, PreprocConfig(**_PP))(
        {k: torch.from_numpy(v) for k, v in batches[0].items()})
    np.testing.assert_allclose(got_ev["loss"].item(), float(want_ev["loss"]), rtol=1e-4)


# -- finetune ----------------------------------------------------------------

_FT = dict(num_classes=5, img_size=(S, S), patch_size=(4, 4), in_chans=3, embed_dim=32,
           depth=2, num_heads=4, init_values=0.1)


@pytest.mark.parametrize("update_freq", [1, 2])
def test_finetune_steps_on_images_match_jax(monkeypatch, update_freq):
    """Two optimizer steps (mixup off, layer decay 0.9, clip 1.0, EMA) on
    image micro-batches through preprocess_image_cls: loss and grad norm to
    1e-5 relative, the parameters to 1e-4 relative L2 per tensor; then the
    eval step on an image batch."""
    monkeypatch.setattr(jax_attention, "ENABLED", True)
    rng = np.random.default_rng(1)
    fmodel = jax_create_model("ft_vit", dtype=jnp.float32, **_FT)
    params = _redraw(rng, jax.jit(fmodel.init)(jax.random.key(0), jnp.zeros((1, S, S, 3))))
    tmodel = create_model("ft_vit", **_FT)
    tmodel.load_state_dict(from_jax_params(params), strict=True)
    micro = [_image_batches(rng, update_freq) for _ in range(2)]

    tx = jax_optim.create_optimizer(params, as_schedule_fn(LR), wd_schedule=as_schedule_fn(WD),
                                    weight_decay=0.05, layer_decay=0.9, num_layers=2,
                                    clip_grad=1.0)
    jstep = jax_steps.make_finetune_train_step(
        fmodel, tx, JaxPreprocConfig(**_PP), 5, smoothing=0.1, update_freq=update_freq,
        ema_decay=0.9, image_preproc=functools.partial(jax_preprocess_image_cls,
                                                       is_train=True, **_AUG))
    jp, state, jema, want = params, tx.init(params), params, []
    for ms in micro:
        batch = {k: jnp.asarray(np.stack([m[k] for m in ms])) for k in ms[0]}
        jp, state, jema, m = jstep(jp, state, jema, batch, jax.random.key(0))
        want.append({k: float(v) for k, v in m.items()})

    opt = optim.create_optimizer(tmodel, 1e-3, 0.05, layer_decay=0.9, num_layers=2)
    ema = [p.detach().clone() for p in tmodel.parameters()]
    tstep = steps.make_finetune_train_step(
        tmodel, opt, PreprocConfig(**_PP), 5, LR, WD, smoothing=0.1, update_freq=update_freq,
        ema=ema, ema_decay=0.9, clip_grad=1.0,
        image_preproc=functools.partial(preprocess_image_cls, is_train=True, **_AUG))
    for t, ms in enumerate(micro):
        m = tstep([_torch(b) for b in ms], t)
        np.testing.assert_allclose(m["loss"].item(), want[t]["loss"], rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(), want[t]["grad_norm"], rtol=1e-5)
    ref = from_jax_params(jax.device_get(jp))
    for name, p in tmodel.named_parameters():
        w = ref[name].numpy()
        assert np.linalg.norm(p.detach().numpy() - w) / np.linalg.norm(w) <= 1e-4, name

    eval_batch = _image_batches(rng, 1)[0]
    want_ev = jax_steps.make_finetune_eval_step(fmodel, JaxPreprocConfig(**_PP))(
        jp, jax.tree.map(jnp.asarray, eval_batch))
    got_ev = steps.make_finetune_eval_step(tmodel, PreprocConfig(**_PP))(
        _torch(eval_batch, with_draws=False))
    np.testing.assert_allclose(got_ev["loss"].item(), float(want_ev["loss"]), rtol=1e-5)
    assert got_ev["acc1"].item() == float(want_ev["acc1"])


# -- the VAE -----------------------------------------------------------------

def test_vae_steps_on_images_match_jax():
    """Three VAE steps (inject_noise, scale_by_adam, the clip active) on image
    batches through preprocess_image_cls: loss and pre-clip grad norm to
    1e-4 relative; the eval step's MSE and codes on an image batch."""
    rng = np.random.default_rng(2)
    fvae, variables, tvae = _vae_pair(rng, kl_div_loss_weight=1e-3)
    batches = _image_batches(rng, 3)
    noises = [rng.gumbel(size=(B, 8, 8, 32)).astype(np.float32) for _ in range(3)]
    clip, lrs, temps = 1e-2, (1e-3, 5e-4, 2.5e-4), (1.0, 0.8, 0.6)

    opt = torch.optim.Adam(tvae.parameters(), lr=1.0, betas=(0.9, 0.999), eps=1e-8)
    tstep = steps.make_vae_train_step(
        tvae, opt, PreprocConfig(**_PP), clip, inject_noise=True,
        image_preproc=functools.partial(preprocess_image_cls, is_train=True, **_AUG))
    got = [{k: v.item() for k, v in tstep(_torch(b), torch.from_numpy(g), lr, tp).items()}
           for b, g, lr, tp in zip(batches, noises, lrs, temps)]

    tx = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
    jstep = jax_steps.make_vae_train_step(
        fvae, tx, JaxPreprocConfig(**_PP), inject_noise=True,
        image_preproc=functools.partial(jax_preprocess_image_cls, is_train=True, **_AUG))
    p, state = variables, tx.init(variables)
    for t, (b, g, lr, tp) in enumerate(zip(batches, noises, lrs, temps)):
        p, state, m = jstep(p, state, jax.tree.map(jnp.asarray, b), jnp.asarray(g),
                            jnp.float32(lr), jnp.float32(tp), jnp.float32(clip))
        np.testing.assert_allclose(got[t]["loss"], float(m["loss"]), rtol=1e-4)
        np.testing.assert_allclose(got[t]["grad_norm"], float(m["grad_norm"]), rtol=1e-4)
    assert got[0]["grad_norm"] > clip

    want_ev = jax_steps.make_vae_eval_step(fvae, JaxPreprocConfig(**_PP))(
        p, jax.tree.map(jnp.asarray, batches[0]))
    got_ev = steps.make_vae_eval_step(tvae, PreprocConfig(**_PP))(
        _torch(batches[0], with_draws=False))
    np.testing.assert_array_equal(got_ev["images"].numpy(), batches[0]["image"])
    np.testing.assert_array_equal(got_ev["ids"].numpy(), np.asarray(want_ev["ids"]))
    np.testing.assert_allclose(got_ev["loss"].item(), float(want_ev["loss"]), rtol=1e-5)


# -- the three CLIs on --device cpu ---------------------------------------------

@pytest.fixture(scope="module")
def jpeg_root(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("imnet")
    rng = np.random.default_rng(3)
    for split, n_per in (("train", 8), ("val", 3)):
        for ci, cls in enumerate(["dark", "bright"]):
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(n_per):
                w, h = int(rng.integers(40, 97)), int(rng.integers(40, 97))
                arr = np.clip((40 if ci == 0 else 180) + rng.normal(0, 25, (h, w, 3)), 0, 255)
                Image.fromarray(arr.astype(np.uint8)).save(d / f"s{i}.jpg", quality=90)
    return str(root)


_SMALL = ["--device", "cpu", "--dtype", "float32", "--num_workers", "0", "--seed", "0",
          "--max_random_shift_evs", "2"]


@pytest.fixture(scope="module")
def vae_run(jpeg_root, tmp_path_factory):
    from mem_tpu_torch.cli import train_vae as T

    out = str(tmp_path_factory.mktemp("vae_out"))
    hist = T.main(["--data_path", jpeg_root, "--data_set", "IMNET", "--output_dir", out,
                   "--epochs", "2", "--batch_size", "8", "--input_size", "32",
                   "--num_tokens", "16", "--emb_dim", "8", "--num_layers", "2",
                   "--hidden_dim", "8", "--num_resnet_blocks", "1", "--eval_freq", "1",
                   "--aa", "rand-m5", "--reprob", "0.25", "--num_images_save", "2",
                   "--eval_data_path", "/nonexistent", "--dump_recon_dir",
                   os.path.join(out, "recon")] + _SMALL)
    return out, hist


def test_train_vae_imnet_cli(vae_run, capsys):
    from mem_tpu_torch.utils.checkpoint import load_checkpoint

    out, hist = vae_run
    assert [h[0] for h in hist] == [0, 1, 2, 3] and all(np.isfinite(h[1]) for h in hist)
    ck = load_checkpoint(os.path.join(out, "checkpoint-final.pth"))
    # --input_H / --input_W follow --input_size
    assert ck["hparams"]["input_H"] == ck["hparams"]["input_W"] == 32
    assert os.path.exists(os.path.join(out, "recon", "recon_ep1.png"))


def test_pretraining_imnet_cli_on_the_vae(vae_run, jpeg_root, tmp_path):
    from mem_tpu_torch.cli import run_mem_pretraining as R
    from mem_tpu_torch.utils.checkpoint import load_checkpoint

    flags = ["--data_set", "IMNET", "--data_path", jpeg_root, "--output_dir",
             str(tmp_path / "pt"), "--discrete_vae_weight_path",
             os.path.join(vae_run[0], "checkpoint-final.pth"), "--batch_size", "8",
             "--input_H", "32", "--input_W", "32", "--num_layers", "2",
             "--transformer_emb", "32", "--transformer_depth", "2", "--transformer_heads", "2",
             "--num_tokens", "16", "--num_mask_patches", "16",
             "--min_mask_patches_per_block", "4", "--warmup_epochs", "0",
             "--save_ckpt_freq", "1", "--dump_recon_dir", str(tmp_path / "dump"),
             "--recon_grad_norm_thresh", "0"] + _SMALL
    hist = R.main(flags + ["--epochs", "1"])
    assert len(hist) == 2 and all(np.isfinite(h[1]) and h[2] is not None for h in hist)
    assert {"recon_ep0.png", "mask_ep0.png"} <= set(os.listdir(tmp_path / "dump"))
    resumed = R.main(flags + ["--epochs", "2"])
    assert [h[0] for h in resumed] == [2, 3]
    assert int(load_checkpoint(str(tmp_path / "pt" / "checkpoint-final.pth"))["epoch"]) == 1


def test_finetune_imnet_cli_default_aa_and_mixup(jpeg_root, tmp_path, capsys):
    from mem_tpu_torch.cli import run_class_finetuning as F

    out = tmp_path / "ft"
    flags = ["--data_path", jpeg_root, "--data_set", "IMNET", "--output_dir", str(out),
             "--warmup_epochs", "0", "--batch_size", "8", "--num_layers", "3",
             "--transformer_emb", "32", "--transformer_depth", "1", "--transformer_heads", "2",
             "--input_H", "32", "--input_W", "32", "--input_size", "32",
             "--mixup", "0.8", "--cutmix", "1.0", "--mixup_prob", "1.0",
             "--eval_data_path", "/nonexistent", "--save_ckpt_freq", "1",
             "--dump_samples_dir", str(tmp_path / "samples"), "--dump_samples_n", "4"] + _SMALL
    res = F.main(flags + ["--epochs", "1"])
    assert "--eval_data_path is ignored" in capsys.readouterr().out
    assert all(np.isfinite(h[1]) for h in res["history"]) and len(res["evals"]) == 1
    assert (out / "checkpoint-0.pth").exists() and len(os.listdir(tmp_path / "samples")) == 4
    # 6 val images in batches of 8: one batch, padded by wrapping
    assert res["evals"][0][1]["acc1"] in {100.0 * k / 8 for k in range(9)}
    ev = F.main(flags + ["--epochs", "1", "--eval"])
    assert ev["evals"][0][1]["loss"] == pytest.approx(res["evals"][0][1]["loss"], rel=1e-6)
