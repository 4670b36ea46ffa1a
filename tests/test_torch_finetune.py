"""The classification finetune of the port held against the JAX package:
``ft_vit`` under the two model toggles (``FLAT_ATTN = False`` -> K5a/K5c,
``FUSED_MLP`` -> K6f/K6b; the flax side through its Pallas kernels in
interpret mode), the attention-dropout path, the probe BatchNorm on batch
statistics, whole train steps and the eval step against
``make_finetune_train_step`` / ``make_finetune_eval_step``, the optimizer's
finetune options, and the CLI on the CPU (two epochs, resume across an EMA
flip, ``--eval``, the flags that raise)."""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mem_tpu.models.vit as jax_vit
import mem_tpu.ops.attention as jax_attention
import mem_tpu.ops.mlp as jax_mlp
import mem_tpu.ops.voxelize as jax_voxelize
from mem_tpu.data.device_pipeline import PreprocConfig as JaxPreprocConfig
from mem_tpu.models.registry import create_model as jax_create_model
from mem_tpu.train import optim as jax_optim
from mem_tpu.train.schedules import as_schedule_fn
from mem_tpu.train.steps import make_finetune_eval_step as jax_make_eval_step
from mem_tpu.train.steps import make_finetune_train_step as jax_make_train_step
from mem_tpu_torch.data.device_pipeline import PreprocConfig
from mem_tpu_torch.models import vit as tvit
from mem_tpu_torch.models.registry import create_model
from mem_tpu_torch.train import optim
from mem_tpu_torch.train.schedules import cosine_scheduler
from mem_tpu_torch.train.steps import (finetune_cross_entropy, make_finetune_eval_step,
                                       make_finetune_train_step)
from mem_tpu_torch.utils.weights import from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MODEL = dict(num_classes=5, img_size=(32, 32), patch_size=(4, 4), in_chans=3, embed_dim=32,
              depth=2, num_heads=4, init_values=0.1)
LR = cosine_scheduler(1e-3, 1e-4, 1, 3)
WD = cosine_scheduler(0.05, 0.2, 1, 3)


def _redraw(rng, tree):
    def one(path, leaf):
        name = jax.tree_util.keystr(path)
        if "var" in name:
            return jnp.asarray(1.0 + 0.5 * rng.random(leaf.shape), jnp.float32)
        base = 1.0 if "scale" in name else 0.0
        return jnp.asarray(base + 0.1 * rng.standard_normal(leaf.shape), jnp.float32)

    return jax.device_get(jax.tree_util.tree_map_with_path(one, tree))


def _pair(rng, dtype=("f32"), **over):
    kw = dict(_MODEL, **over)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    fmodel = jax_create_model("ft_vit", dtype=jdt, **kw)
    variables = _redraw(rng, jax.jit(fmodel.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 3))))
    tmodel = create_model("ft_vit", dtype=tdt, **kw)
    tmodel.load_state_dict(from_jax_params(variables), strict=True)
    return fmodel, variables, tmodel


def _toggles(mp, flat_attn: bool, fused_mlp: bool):
    """Set the two toggles on both packages, as scripts/trace_pretrain.py
    sets the reference's; the flax side takes its Pallas kernels on the CPU."""
    mp.setattr(jax_attention, "ENABLED", True)
    mp.setattr(jax_vit, "FLAT_ATTN", flat_attn)
    mp.setattr(jax_vit, "FUSED_MLP", fused_mlp)
    mp.setattr(jax_mlp, "FORCE", fused_mlp)
    mp.setattr(tvit, "FLAT_ATTN", flat_attn)
    mp.setattr(tvit, "FUSED_MLP", fused_mlp)


# -- the model under the toggles ---------------------------------------------

def test_toggle_defaults_are_the_reference_s():
    assert (tvit.FLAT_ATTN, tvit.FUSED_MLP) == (jax_vit.FLAT_ATTN, jax_vit.FUSED_MLP) \
        == (True, False)


@pytest.mark.parametrize("flat_attn,fused_mlp", [(False, False), (True, True), (False, True)],
                         ids=["bhnd_attention", "fused_mlp", "both"])
def test_ft_vit_under_toggles_matches_flax(rng, monkeypatch, flat_attn, fused_mlp):
    """A 2-block narrow ft_vit, f32: logits and the gradient of their
    squared sum for every parameter, both sides on the same toggles (flax
    through K5a/K5c and K6f/K6b in interpret mode). Logits rtol 1e-4 as
    test_torch_vit; gradients 1e-4 relative L2."""
    _toggles(monkeypatch, flat_attn, fused_mlp)
    fmodel, variables, tmodel = _pair(rng)
    x = rng.random((3, 32, 32, 3)).astype(np.float32)
    want = np.asarray(fmodel.apply(variables, jnp.asarray(x)))
    gwant = from_jax_params(jax.device_get(jax.grad(
        lambda v: jnp.sum(fmodel.apply(v, jnp.asarray(x)) ** 2))(variables)))
    got = tmodel.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-5)
    (got ** 2).sum().backward()
    for name, p in tmodel.named_parameters():
        w = gwant[name].numpy()
        assert np.linalg.norm(p.grad.numpy() - w) <= 1e-4 * np.linalg.norm(w) + 1e-7, name


def test_toggles_reach_their_wrappers(rng, monkeypatch):
    """With the toggles on, every block goes through ``fused_attention`` and
    ``mlp_fused`` and none through the flat attention; off, the reverse."""
    calls = {"bhnd": 0, "flat": 0, "mlp": 0}

    def spy(name, fn):
        def inner(*a):
            calls[name] += 1
            return fn(*a)
        return inner

    monkeypatch.setattr(tvit, "fused_attention", spy("bhnd", tvit.fused_attention))
    monkeypatch.setattr(tvit, "fused_attention_flat", spy("flat", tvit.fused_attention_flat))
    monkeypatch.setattr(tvit, "mlp_fused", spy("mlp", tvit.mlp_fused))
    tmodel = create_model("ft_vit", **_MODEL).eval()
    x = torch.from_numpy(rng.random((2, 32, 32, 3)).astype(np.float32))
    tmodel(x)
    assert calls == {"bhnd": 0, "flat": 2, "mlp": 0}
    monkeypatch.setattr(tvit, "FLAT_ATTN", False)
    monkeypatch.setattr(tvit, "FUSED_MLP", True)
    tmodel(x)
    assert calls == {"bhnd": 2, "flat": 2, "mlp": 2}


def test_bf16_logits_under_toggles_match_flax(rng, monkeypatch):
    """bf16 compute under both toggles: test_torch_vit's bf16 bounds (2e-2
    max abs, 1e-2 relative L2)."""
    _toggles(monkeypatch, False, True)
    fmodel, variables, tmodel = _pair(rng, "bf16")
    x = rng.random((3, 32, 32, 3)).astype(np.float32)
    want = np.asarray(fmodel.apply(variables, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got = tmodel.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-2


def test_attention_dropout_path_matches_flax_in_eval(rng, monkeypatch):
    """``attn_drop_rate > 0`` takes both packages onto the einsum path
    (vit.py:374); with dropout off in eval the logits must agree, and they
    must agree with the fused path's."""
    monkeypatch.setattr(jax_attention, "ENABLED", True)
    fmodel, variables, tmodel = _pair(rng, attn_drop_rate=0.1, drop_rate=0.1)
    x = rng.random((3, 32, 32, 3)).astype(np.float32)
    want = np.asarray(fmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel.eval()(torch.from_numpy(x))
        fused = create_model("ft_vit", **_MODEL)
        fused.load_state_dict(tmodel.state_dict())
        np.testing.assert_allclose(got.numpy(), fused.eval()(torch.from_numpy(x)).numpy(),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_training_mode_dropouts_draw_from_the_generator(rng):
    tmodel = create_model("ft_vit", drop_rate=0.2, attn_drop_rate=0.2, drop_path_rate=0.2,
                          **_MODEL).train()
    x = torch.from_numpy(rng.random((4, 32, 32, 3)).astype(np.float32))
    with pytest.raises(ValueError, match="Generator"):
        tmodel(x)
    a = tmodel(x, generator=torch.Generator().manual_seed(3))
    b = tmodel(x, generator=torch.Generator().manual_seed(3))
    c = tmodel(x, generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    torch.testing.assert_close(tmodel.eval()(x), tmodel.eval()(x), rtol=0, atol=0)


def test_probe_batch_norm_training_mode_matches_flax(rng):
    """``use_batch_norm`` carried across by ``from_jax_params`` (running
    statistics included), on running statistics and, with ``train_bn``, on
    batch statistics with the running ones moved (momentum 0.9)."""
    fmodel, variables, tmodel = _pair(rng, use_batch_norm=True)
    x = rng.random((6, 32, 32, 3)).astype(np.float32)
    want, mutated = fmodel.apply(variables, jnp.asarray(x), train_bn=True,
                                 mutable=["batch_stats"])
    got = tmodel.eval()(torch.from_numpy(x), train_bn=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    bn = mutated["batch_stats"]["batch_norm"]
    np.testing.assert_allclose(tmodel.batch_norm.running_mean.numpy(), np.asarray(bn["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tmodel.batch_norm.running_var.numpy(), np.asarray(bn["var"]),
                               rtol=1e-4, atol=1e-6)
    fmodel, variables, tmodel = _pair(rng, use_batch_norm=True)
    with torch.no_grad():
        np.testing.assert_allclose(tmodel.eval()(torch.from_numpy(x)).numpy(),
                                   np.asarray(fmodel.apply(variables, jnp.asarray(x))),
                                   rtol=1e-4, atol=1e-5)


# -- the loss and the optimizer ----------------------------------------------

def test_cross_entropy_forms(rng):
    logits = torch.from_numpy(rng.standard_normal((6, 5)).astype(np.float32))
    hard = torch.from_numpy(rng.integers(0, 5, 6))
    want = torch.nn.functional.cross_entropy(logits, hard)
    torch.testing.assert_close(finetune_cross_entropy(logits, hard, 5), want)
    torch.testing.assert_close(
        finetune_cross_entropy(logits, hard, 5, 0.1),
        torch.nn.functional.cross_entropy(logits, hard, label_smoothing=0.1))
    soft = torch.softmax(torch.from_numpy(rng.standard_normal((6, 5)).astype(np.float32)), -1)
    torch.testing.assert_close(finetune_cross_entropy(logits, soft, 5, 0.1),
                               torch.nn.functional.cross_entropy(logits, soft))


def test_finetune_optimizer_options(rng):
    tmodel = create_model("ft_vit", **_MODEL)
    names = dict(tmodel.named_parameters())
    table = "blocks.0.attn.relative_position_bias_table"
    assert optim.decays(table, names[table])
    assert not optim.decays(table, names[table],
                            optim.SKIP_NAMES + ("relative_position_bias_table",))
    opt = optim.create_optimizer(tmodel, 1e-3, 0.05, layer_decay=0.9, num_layers=2,
                                 freeze_backbone=True)
    by_scale = {g["lr_scale"]: g for g in opt.param_groups if g["params"]}
    head = {id(p) for n, p in names.items() if n.startswith("head.")}
    assert set(by_scale) == {0.0, 1.0}
    assert {id(p) for g in opt.param_groups if g["lr_scale"] == 1.0 for p in g["params"]} == head
    before = {n: p.detach().clone() for n, p in names.items()}
    for p in names.values():
        p.grad = torch.ones_like(p)
    optim.set_schedule(opt, 1e-2, 0.1)
    opt.step()
    moved = {n for n, p in names.items() if not torch.equal(p, before[n])}
    assert moved == {"head.weight", "head.bias"}
    with pytest.raises(ValueError, match="unsupported optimizer"):
        optim.create_optimizer(tmodel, 1e-3, 0.05, opt="sgdw")


# -- whole steps -------------------------------------------------------------

def _micro_batches(rng, n, B=4, N=1200):
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
                    "aug_seed": np.arange(B, dtype=np.uint32),
                    "label": rng.integers(0, 5, B).astype(np.int32)})
    return out


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items() if k != "aug_seed"}


_PP = dict(input_h=32, input_w=32, canvas_h=48, canvas_w=48, rand_aug=False, color_jitter=0.0,
           normalize_events=True)


@pytest.mark.parametrize("update_freq,ema,smoothing", [(1, True, 0.1), (2, False, 0.0),
                                                       (2, True, 0.1)],
                         ids=["uf1_ema_smooth", "uf2_noema_hard", "uf2_ema_smooth"])
def test_train_steps_match_jax(rng, monkeypatch, update_freq, ema, smoothing):
    """Two optimizer steps (mixup off, drop-path 0, f32, layer decay 0.9, a
    wd schedule, clip 1.0) from the same weights on the same micro-batches:
    loss and grad norm 1e-5 relative, updated parameters and the EMA 1e-4
    relative L2 per tensor."""
    monkeypatch.setattr(jax_attention, "ENABLED", True)
    monkeypatch.setattr(jax_voxelize, "PALLAS_HIST", True)
    fmodel, params, tmodel = _pair(rng)
    decay = 0.9 if ema else None
    steps = [_micro_batches(rng, update_freq) for _ in range(2)]

    tx = jax_optim.create_optimizer(params, as_schedule_fn(LR), wd_schedule=as_schedule_fn(WD),
                                    weight_decay=0.05, layer_decay=0.9, num_layers=2,
                                    clip_grad=1.0)
    jstep = jax_make_train_step(fmodel, tx, JaxPreprocConfig(**_PP), 5, mixup_fn=None,
                                smoothing=smoothing, update_freq=update_freq, ema_decay=decay)
    state = tx.init(params)
    jparams = params
    jema = jax.tree.map(lambda a: jnp.array(a), params) if ema else None
    want = []
    for micros in steps:
        batch = {k: jnp.asarray(np.stack([m[k] for m in micros])) for k in micros[0]}
        if ema:
            jparams, state, jema, m = jstep(jparams, state, jema, batch, jax.random.key(0))
        else:
            jparams, state, m = jstep(jparams, state, batch, jax.random.key(0))
        want.append({k: float(v) for k, v in m.items()})

    opt = optim.create_optimizer(tmodel, 1e-3, 0.05, layer_decay=0.9, num_layers=2)
    tema = [p.detach().clone() for p in tmodel.parameters()] if ema else None
    tstep = make_finetune_train_step(tmodel, opt, PreprocConfig(**_PP), 5, LR, WD,
                                     smoothing=smoothing, update_freq=update_freq, ema=tema,
                                     ema_decay=decay, clip_grad=1.0)
    for t, micros in enumerate(steps):
        m = tstep([_torch_batch(mb) for mb in micros], t)
        np.testing.assert_allclose(m["loss"].item(), want[t]["loss"], rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(), want[t]["grad_norm"], rtol=1e-5)

    def close(got, tree, what):
        ref = from_jax_params(jax.device_get(tree))
        for (name, _), g in zip(tmodel.named_parameters(), got):
            w = ref[name].numpy()
            err = np.linalg.norm(g.detach().numpy() - w) / np.linalg.norm(w)
            assert err <= 1e-4, (what, name, err)

    close(list(tmodel.parameters()), jparams, "params")
    if ema:
        close(tema, jema, "ema")
        assert not torch.equal(tema[0], next(tmodel.parameters()).detach())


def test_train_step_argument_checks(rng):
    tmodel = create_model("ft_vit", **_MODEL)
    opt = optim.create_optimizer(tmodel, 1e-3, 0.05)
    with pytest.raises(ValueError, match="both ema and ema_decay"):
        make_finetune_train_step(tmodel, opt, PreprocConfig(**_PP), 5, LR, WD, ema_decay=0.9)
    step = make_finetune_train_step(tmodel, opt, PreprocConfig(**_PP), 5, LR, WD, update_freq=2)
    with pytest.raises(ValueError, match="expected 2 micro-batches"):
        step([{}], 0)


def test_eval_step_matches_jax(rng, monkeypatch):
    monkeypatch.setattr(jax_attention, "ENABLED", True)
    monkeypatch.setattr(jax_voxelize, "PALLAS_HIST", True)
    fmodel, params, tmodel = _pair(rng)
    batch = _micro_batches(rng, 1)[0]
    want = jax_make_eval_step(fmodel, JaxPreprocConfig(**_PP), with_predictions=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_finetune_eval_step(tmodel, PreprocConfig(**_PP), with_predictions=True)(
        _torch_batch(batch))
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
    assert got["acc1"].item() == float(want["acc1"]) and got["acc5"].item() == 100.0
    np.testing.assert_array_equal(got["topk_ids"].numpy(), np.asarray(want["topk_ids"]))
    np.testing.assert_allclose(got["topk_probs"].numpy(), np.asarray(want["topk_probs"]),
                               rtol=1e-4)
    assert set(make_finetune_eval_step(tmodel, PreprocConfig(**_PP))(
        _torch_batch(batch))) == {"loss", "acc1", "acc5"}


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
    pt = create_model("pt_vit", img_size=(32, 32), patch_size=(4, 4), embed_dim=32, depth=2,
                      num_heads=4, vocab_size=32, use_shared_rel_pos_bias=True)
    pt.init_weights(torch.Generator().manual_seed(1))
    torch.save({"model": pt.state_dict(), "epoch": 0}, tmp_path / "pt.pth")
    return str(root), str(tmp_path / "pt.pth"), pt


def _flags(tmp_path, root, pth):
    return ["--config", os.path.join(REPO, "configs", "ncaltech.conf"), "--data_path", root,
            "--finetune", pth, "--output_dir", str(tmp_path / "out"), "--device", "cpu",
            "--dtype", "float32", "--input_H", "32", "--input_W", "32", "--num_layers", "2",
            "--transformer_emb", "32", "--transformer_depth", "2", "--transformer_heads", "4",
            "--batch_size", "4", "--update_freq", "2", "--save_ckpt_freq", "1",
            "--num_workers", "0", "--max_random_shift_evs", "2", "--slice_max_evs", "1500",
            "--warmup_steps", "2", "--mixup_prob", "1.0", "--lr", "1e-3"]


def test_cli_trains_evaluates_checkpoints_and_resumes(tmp_path):
    from mem_tpu_torch.cli import run_class_finetuning as R

    root, pth, pt = _write_inputs(tmp_path)
    flags = _flags(tmp_path, root, pth)
    out = tmp_path / "out"
    r = R.main(flags + ["--epochs", "2", "--dump_samples_dir", str(tmp_path / "dump"),
                        "--dump_samples_n", "3"])
    # 12 samples / (micro-batch 2 x update_freq 2) = 3 optimizer steps per epoch
    assert [h[0] for h in r["history"]] == [0, 2, 3, 5]
    assert all(np.isfinite(h[1]) and h[2] > 0 for h in r["history"])
    assert [e[0] for e in r["evals"]] == [0, 1] and r["evals"][0][2] is not None
    assert sorted(os.listdir(out)) == ["checkpoint-0.pth", "checkpoint-1.pth",
                                       "checkpoint-best.pth"]
    assert len(os.listdir(tmp_path / "dump")) == 3
    pay = torch.load(out / "checkpoint-1.pth", weights_only=True)
    assert set(pay) == {"model", "optimizer", "ema", "epoch", "best_acc"} and pay["epoch"] == 1
    assert set(pay["ema"]) == {n for n, _ in create_model(
        "ft_vit", num_classes=2, img_size=(32, 32), patch_size=(4, 4), embed_dim=32, depth=2,
        num_heads=4).named_parameters()}
    # the surgery: the shared table went into every block, the trunk came across
    first = torch.load(out / "checkpoint-0.pth", weights_only=True)["model"]
    assert first["blocks.1.attn.relative_position_bias_table"].shape == (15 * 15 + 3, 4)
    assert "rel_pos_bias.relative_position_bias_table" not in first and "lm_head.weight" not in first
    # resume with EMA switched off (the checkpoint's EMA is dropped), then
    # back on (re-seeded), then --eval with a dump
    r = R.main(flags + ["--epochs", "3", "--model_ema", "0"])
    assert [h[0] for h in r["history"]] == [6, 8] and r["evals"][0][2] is None
    assert "ema" not in torch.load(out / "checkpoint-2.pth", weights_only=True)
    r = R.main(flags + ["--epochs", "4"])
    assert [h[0] for h in r["history"]] == [9, 11]
    assert "ema" in torch.load(out / "checkpoint-3.pth", weights_only=True)
    dump = tmp_path / "pred" / "dump.jsonl"
    r = R.main(flags + ["--epochs", "4", "--eval", "--eval_dump", str(dump)])
    assert r["history"] == [] and r["evals"][0][0] == 3
    rows = [json.loads(line) for line in dump.read_text().splitlines()]
    assert [row["index"] for row in rows] == [0, 1, 2, 3]
    assert all(len(row["topk_ids"]) == 2 and abs(sum(row["topk_probs"]) - 1) < 1e-4
               for row in rows)
    # an explicit --resume of a file without optimizer state is refused
    with pytest.raises(SystemExit, match="not a resumable checkpoint"):
        R.main(flags + ["--epochs", "4", "--resume", str(out / "checkpoint-best.pth")])


def test_cli_finetune_checkpoint_must_be_a_pth(tmp_path):
    from mem_tpu_torch.cli import run_class_finetuning as R

    root, pth, _ = _write_inputs(tmp_path)
    flags = _flags(tmp_path, root, pth)
    flags[flags.index("--finetune") + 1] = str(tmp_path / "orbax_dir")
    with pytest.raises(ValueError, match="export_torch"):
        R.main(flags + ["--epochs", "1"])


def test_cli_int8_runs_the_eval_forwards(tmp_path, monkeypatch):
    """--int8 1: the training steps ignore the flag (the same history as
    without it), the evaluations run W8A8 (3 int8 products a block a val
    batch: 2 batches, 2 blocks), --eval too; the flag is restored after each
    run and the int8 predictions stay within int8 noise of the f32 ones."""
    from mem_tpu_torch.cli import run_class_finetuning as R
    from mem_tpu_torch.ops import quant

    root, pth, _ = _write_inputs(tmp_path)
    flags = _flags(tmp_path, root, pth) + ["--epochs", "1", "--model_ema", "0"]
    calls = []
    real = quant.int8_matmul_reference
    monkeypatch.setattr(quant, "int8_matmul_reference",
                        lambda a, b: calls.append(a.shape) or real(a, b))
    r8 = R.main(flags + ["--int8", "1"])
    assert len(calls) == 12 and tvit.INT8_GEMM is False
    r32 = R.main(flags + ["--output_dir", str(tmp_path / "f32")])
    assert len(calls) == 12 and r8["history"] == r32["history"]
    dumps = {}
    for name, extra in (("int8", ["--int8", "1"]), ("f32", [])):
        dumps[name] = tmp_path / f"{name}.jsonl"
        R.main(flags + extra + ["--eval", "--eval_dump", str(dumps[name])])
    assert len(calls) == 24 and tvit.INT8_GEMM is False
    rows = {k: [json.loads(ln) for ln in v.read_text().splitlines()] for k, v in dumps.items()}
    p8, p32 = (np.array([r["topk_probs"] for r in rows[k]]) for k in ("int8", "f32"))
    assert 0 < np.abs(p8 - p32).max() < 0.05


@pytest.mark.parametrize("flags,exc,match", [
    (["--zero1", "1", "--fsdp", "1"], ValueError, "placement mode"),
    (["--fsdp", "1", "--zero1", "1", "--data_set", "IMNET"], ValueError, "placement mode"),
    (["--data_set", "CIFAR"], NotImplementedError, "data_set 'CIFAR'"),
])
def test_cli_unported_options_raise(flags, exc, match):
    """--zero1 / --fsdp are ported; both at once raise the reference's
    ValueError (mesh.py:175-179); an unknown data set is not ported."""
    from mem_tpu_torch.cli import run_class_finetuning as R

    with pytest.raises(exc, match=match):
        R.check_ported(R.get_args(["--data_path", "x"] + flags))


def test_cli_check_ported_accepts_imnet():
    """--data_set IMNET is ported (the real-image baseline)."""
    from mem_tpu_torch.cli import run_class_finetuning as R

    R.check_ported(R.get_args(["--data_path", "x", "--data_set", "IMNET"]))


def test_cli_other_optimizers_raise(tmp_path):
    from mem_tpu_torch.cli import run_class_finetuning as R

    root, pth, _ = _write_inputs(tmp_path)
    with pytest.raises(ValueError, match="adahessian needs Hessian-diagonal"):
        R.main(_flags(tmp_path, root, pth) + ["--epochs", "1", "--opt", "adahessian"])


def test_cli_flags_are_the_reference_s():
    """Every flag of the reference's parser binds in the port's (plus
    ``--device`` as a real option), with the same defaults for the recipe."""
    from mem_tpu.cli import run_class_finetuning as J
    from mem_tpu_torch.cli import run_class_finetuning as R

    want, got = vars(J.get_args(["--data_path", "x"])), vars(R.get_args(["--data_path", "x"]))
    assert set(want) <= set(got), sorted(set(want) - set(got))
    differ = {k for k in want if want[k] != got[k]}
    assert differ <= {"device"}, differ
    assert got["device"] == "cuda"


def test_cli_device_cuda_without_card_raises(tmp_path, monkeypatch):
    from mem_tpu_torch.cli import run_class_finetuning as R

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, pth, _ = _write_inputs(tmp_path)
    flags = _flags(tmp_path, root, pth)
    flags[flags.index("--device") + 1] = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.main(flags + ["--epochs", "1"])
