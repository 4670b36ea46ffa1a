"""The port's training step held against the JAX package: AdamW (the update
and the weight-decay mask) against scheduled_adamw, three whole
make_pretrain_train_step steps against the jitted JAX step on the same
weights and batches, and the pretraining CLI on the CPU (checkpoint schema,
auto-resume, the options that raise, no jax in the import)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mem_tpu.ops.attention as jax_attention
import mem_tpu.ops.voxelize as jax_voxelize
from mem_tpu.data.device_pipeline import PreprocConfig as JaxPreprocConfig
from mem_tpu.models.discrete_vae import DiscreteVAE as JaxDiscreteVAE
from mem_tpu.models.registry import create_model as jax_create_model
from mem_tpu.train import optim as jax_optim
from mem_tpu.train.schedules import as_schedule_fn
from mem_tpu.train.steps import make_pretrain_train_step as jax_make_step
from mem_tpu.utils.torch_import import import_vit_state_dict
from mem_tpu_torch.data.device_pipeline import PreprocConfig
from mem_tpu_torch.models.discrete_vae import DiscreteVAE
from mem_tpu_torch.models.registry import create_model
from mem_tpu_torch.train import optim
from mem_tpu_torch.train.schedules import cosine_scheduler
from mem_tpu_torch.train.steps import make_pretrain_train_step
from mem_tpu_torch.utils.weights import from_jax_params, vae_from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MODEL = dict(img_size=(32, 32), patch_size=(4, 4), in_chans=3, vocab_size=32, embed_dim=32,
              depth=2, num_heads=4, init_values=0.1, use_shared_rel_pos_bias=True,
              num_masked_tokens=20)
_VAE = dict(num_tokens=32, codebook_dim=8, num_layers=2, num_resnet_blocks=1, hidden_dim=16)
LR = cosine_scheduler(1e-3, 1e-4, 1, 3)
WD = cosine_scheduler(0.05, 0.2, 1, 3)
CLIP = 1.0


def _redraw(rng, tree, he=False):
    def one(path, leaf):
        if "scale" in jax.tree_util.keystr(path):
            return jnp.asarray(1.0 + 0.1 * rng.standard_normal(leaf.shape), jnp.float32)
        if he and leaf.ndim > 1:
            fan_in = int(np.prod(leaf.shape[:-1]))
            return jnp.asarray(rng.standard_normal(leaf.shape) * np.sqrt(2 / fan_in), jnp.float32)
        return jnp.asarray(0.1 * rng.standard_normal(leaf.shape), jnp.float32)

    return jax.device_get(jax.tree_util.tree_map_with_path(one, tree))


def _params(rng):
    fmodel = jax_create_model("pt_vit", dtype=jnp.float32, **_MODEL)
    params = jax.jit(fmodel.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                                  jnp.zeros((1, 64), bool))
    return fmodel, _redraw(rng, params)


# -- AdamW -------------------------------------------------------------------

def test_adamw_matches_scheduled_adamw(rng):
    """Identical grads, clip active, lr and wd schedules: params after each
    of 3 steps to 1e-6."""
    fmodel, params = _params(rng)
    tmodel = create_model("pt_vit", **_MODEL)
    tmodel.load_state_dict(from_jax_params(params), strict=True)
    tx = jax_optim.create_optimizer(params, as_schedule_fn(LR), wd_schedule=as_schedule_fn(WD),
                                    weight_decay=0.05, clip_grad=CLIP)
    state = tx.init(params)
    opt = optim.create_optimizer(tmodel, 1e-3, 0.05)
    tparams = dict(tmodel.named_parameters())
    for t in range(3):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
                             params)
        updates, state = tx.update(grads, state, params)
        params = jax.device_get(jax.tree.map(lambda p, u: p + u, params, updates))
        for name, g in from_jax_params(jax.device_get(grads)).items():
            tparams[name].grad = g
        gnorm = optim.clip_grad_global_norm(tparams.values(), CLIP)
        np.testing.assert_allclose(gnorm.item(), float(jax_optim.grad_global_norm(grads)),
                                   rtol=1e-6)
        optim.set_schedule(opt, float(LR[t]), float(WD[t]))
        opt.step()
        want = from_jax_params(params)
        for name, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                                       atol=1e-6, err_msg=f"step {t} {name}")


def test_wd_mask_equals_build_wd_mask_tree(rng):
    fmodel, params = _params(rng)
    mask = jax_optim.build_wd_mask_tree(params["params"])
    want = from_jax_params({"params": jax.tree.map(
        lambda m, p: np.full(p.shape, m, np.float32), mask, params["params"])})
    tmodel = create_model("pt_vit", **_MODEL)
    got = {n: optim.decays(n, p) for n, p in tmodel.named_parameters()}
    assert set(got) == set(want)
    for name, decays in got.items():
        assert (want[name].numpy() == float(decays)).all(), name
    assert got["mask_token"] and got["rel_pos_bias.relative_position_bias_table"]
    assert not got["cls_token"] and not got["blocks.0.attn.q_bias"]
    opt = optim.create_optimizer(tmodel, 1e-3, 0.05)
    assert [g["weight_decay"] for g in opt.param_groups] == [0.05, 0.0]
    assert opt.defaults["betas"] == (0.9, 0.95)
    with pytest.raises(ValueError, match="Hessian"):
        optim.create_optimizer(tmodel, 1e-3, 0.05, opt="adahessian")


# -- the whole step ----------------------------------------------------------

def _batches(rng, n, B=4, N=1200):
    out = []
    for _ in range(n):
        ev = np.zeros((B, N, 4), np.float32)
        ev[..., 0] = rng.integers(0, 48, (B, N))
        ev[..., 1] = rng.integers(0, 40, (B, N))
        ev[..., 2] = np.sort(rng.integers(0, 10**6, (B, N)), axis=1)
        ev[..., 3] = rng.choice([-1.0, 1.0], (B, N))
        mask = np.zeros((B, 64), bool)
        for b in range(B):
            mask[b, rng.choice(64, int(rng.integers(10, 21)), replace=False)] = True
        out.append({"events": ev, "n_valid": np.array([N, 900, 300, N], np.int32),
                    "sample_h": np.array([40, 33, 40, 28], np.int32),
                    "sample_w": np.array([48, 40, 31, 48], np.int32),
                    "time_flip": rng.random(B) < 0.5, "x_flip": rng.random(B) < 0.5,
                    "shift_xy": rng.integers(-2, 3, (B, 2)).astype(np.int32),
                    "aug_seed": np.arange(B, dtype=np.uint32), "mask": mask})
    return out


@pytest.fixture(scope="module")
def three_steps():
    """3 steps of the jitted JAX step and of the port's step from the same
    weights on the same batches (the JAX attention and histogram through
    their Pallas kernels in interpret mode); built once per module."""
    rng = np.random.default_rng(0)
    fmodel, params = _params(rng)
    fvae = JaxDiscreteVAE(input_hw=(32, 32), **_VAE)
    vae_params = _redraw(rng, jax.jit(fvae.init)(jax.random.key(1), jnp.zeros((1, 32, 32, 3))),
                         he=True)
    pp = dict(input_h=32, input_w=32, canvas_h=48, canvas_w=48, rand_aug=False,
              color_jitter=0.0)
    batches = _batches(rng, 3)
    tmodel = create_model("pt_vit", **_MODEL)
    tmodel.load_state_dict(from_jax_params(params), strict=True)
    tvae = DiscreteVAE((32, 32), **_VAE)
    tvae.load_state_dict(vae_from_jax_params(vae_params), strict=True)
    opt = optim.create_optimizer(tmodel, 1e-3, 0.05)
    tstep = make_pretrain_train_step(tmodel, tvae, opt, PreprocConfig(**pp), LR, WD, CLIP)
    got = [{k: v.item() for k, v in tstep({k: torch.from_numpy(v) for k, v in b.items()
                                           if k != "aug_seed"}, t).items()}
           for t, b in enumerate(batches)]

    tx = jax_optim.create_optimizer(params, as_schedule_fn(LR), wd_schedule=as_schedule_fn(WD),
                                    weight_decay=0.05, clip_grad=CLIP)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_attention, "ENABLED", True)
        mp.setattr(jax_voxelize, "PALLAS_HIST", True)
        jstep = jax_make_step(fmodel, fvae, tx, JaxPreprocConfig(**pp))
        state, want = tx.init(params), []
        for b in batches:
            params, state, m = jstep(params, state, vae_params, jax.tree.map(jnp.asarray, b),
                                     jax.random.key(0))
            want.append({k: float(v) for k, v in m.items()})
    return got, want, tmodel, from_jax_params(jax.device_get(params))


def test_three_steps_metrics_match_jax(three_steps):
    """f32 both sides: the loss and grad norm to 1e-4 relative (sums in
    another order over three steps of preprocessing, two blocks and AdamW),
    mlm_acc exactly up to one flipped argmax in the ~60 masked tokens."""
    got, want, _, _ = three_steps
    for t, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4, err_msg=f"step {t}")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4,
                                   err_msg=f"step {t}")
        assert abs(g["mlm_acc"] - w["mlm_acc"]) <= 1 / 40 + 1e-6, t


def test_three_steps_params_match_jax(three_steps):
    """Params after 3 steps. Adam divides each gradient by its own running
    RMS, so a component whose gradient is ~0 on both sides (noise of 1e-9
    against 1e-9) moves by up to +-lr per step in either direction: atol
    2 * (1e-3 + 7.75e-4 + 3.25e-4) = 4.2e-3 covers that, and 99% of the
    elements must agree to 1e-5."""
    _, _, tmodel, want = three_steps
    n_all = n_close = 0
    for name, p in tmodel.named_parameters():
        d = np.abs(p.detach().numpy() - want[name].numpy())
        assert d.max() <= 4.2e-3, (name, d.max())
        n_all += d.size
        n_close += int((d <= 1e-5).sum())
    assert n_close / n_all >= 0.99, n_close / n_all


# -- the CLI on the CPU ------------------------------------------------------

def _write_inputs(tmp_path):
    rng = np.random.default_rng(0)
    root = tmp_path / "ncaltech101"
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
    vae = DiscreteVAE((32, 32), **_VAE)
    hp = dict(input_H=32, input_W=32, num_tokens=32, emb_dim=8, num_layers=2,
              num_resnet_blocks=1, hidden_dim=16, channels=3, loss="mse")
    torch.save({"model": vae.state_dict(), "hparams": hp}, tmp_path / "vae.pth")
    return str(root), str(tmp_path / "vae.pth")


def _flags(tmp_path, root, vae):
    return ["--config", os.path.join(REPO, "configs", "ncaltech.conf"), "--data_path", root,
            "--discrete_vae_weight_path", vae, "--output_dir", str(tmp_path / "out"),
            "--device", "cpu", "--input_H", "32", "--input_W", "32", "--num_layers", "2",
            "--transformer_emb", "32", "--transformer_depth", "2", "--transformer_heads", "4",
            "--num_tokens", "32", "--num_mask_patches", "20", "--batch_size", "4",
            "--save_ckpt_freq", "1", "--num_workers", "0", "--max_random_shift_evs", "2",
            "--slice_max_evs", "1500", "--mask_pool_size", "16", "--warmup_steps", "2"]


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    from mem_tpu_torch.cli import run_mem_pretraining as R

    root, vae = _write_inputs(tmp_path)
    flags = _flags(tmp_path, root, vae)
    hist = R.main(flags + ["--epochs", "1"])
    assert [h[0] for h in hist] == [0, 1, 2] and all(np.isfinite(h[1]) for h in hist)
    out = tmp_path / "out"
    assert sorted(os.listdir(out)) == ["checkpoint-0.pth", "checkpoint-final.pth"]
    payload = torch.load(out / "checkpoint-0.pth", weights_only=True)
    assert payload["epoch"] == 0 and "optimizer" in payload
    tree = import_vit_state_dict(payload["model"], is_pretrain=True)["params"]
    assert tree["lm_head"]["kernel"].shape == (32, 32)
    assert tree["mask_token"].shape == (1, 1, 32)
    assert set(tree["encoder"]) == {"blocks_0", "blocks_1", "rel_pos_bias"}
    resumed = R.main(flags + ["--epochs", "2"])
    assert [h[0] for h in resumed] == [3, 4, 5]
    assert "checkpoint-1.pth" in os.listdir(out)


@pytest.mark.parametrize("flags,match", [
    (["--fsdp", "1"], "item 15"), (["--zero1", "1"], "item 15"),
])
def test_cli_unported_options_raise(flags, match):
    from mem_tpu_torch.cli import run_mem_pretraining as R

    with pytest.raises(NotImplementedError, match=match):
        R.check_ported(R.get_args(["--data_path", "x"] + flags))


def test_cli_check_ported_accepts_imnet():
    """--data_set IMNET is ported (the two-view JPEG pretraining)."""
    from mem_tpu_torch.cli import run_mem_pretraining as R

    R.check_ported(R.get_args(["--data_path", "x", "--data_set", "IMNET"]))


def test_cli_device_cuda_without_card_raises(tmp_path):
    from mem_tpu_torch.cli import run_mem_pretraining as R

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root, vae = _write_inputs(tmp_path)
    flags = _flags(tmp_path, root, vae)
    flags[flags.index("--device") + 1] = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.main(flags + ["--epochs", "1"])


def test_pretraining_import_loads_no_jax():
    code = ("import sys, mem_tpu_torch.cli.run_mem_pretraining, mem_tpu_torch.train.steps; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'orbax')]; "
            "assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
