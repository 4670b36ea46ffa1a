"""The MAE recipe of the port held against the JAX package: three whole
make_mae_train_step steps against the jitted JAX step (the same weights,
batches and shuffle noise), one finetune step of the MAE classifier against
make_finetune_train_step, and the chain on the CPU: run_mem_pretraining
--MAE 1 -> run_class_finetuning --MAE 1 --finetune -> serve --MAE 1."""
import io
import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mem_tpu.ops.attention as jax_attention
import mem_tpu.ops.voxelize as jax_voxelize
from mem_tpu.data.device_pipeline import PreprocConfig as JaxPreprocConfig
from mem_tpu.models.mae import MaskedAutoencoderViT as JaxMAE
from mem_tpu.models.mae_classifier import MAEVisionTransformer as JaxMAEClassifier
from mem_tpu.train import optim as jax_optim
from mem_tpu.train.schedules import as_schedule_fn
from mem_tpu.train.steps import make_finetune_train_step as jax_make_finetune_step
from mem_tpu.train.steps import make_mae_train_step as jax_make_mae_step
from mem_tpu_torch.data.device_pipeline import PreprocConfig
from mem_tpu_torch.models import mae
from mem_tpu_torch.models.mae_classifier import MAEVisionTransformer
from mem_tpu_torch.train import optim
from mem_tpu_torch.train.schedules import cosine_scheduler
from mem_tpu_torch.train.steps import make_finetune_train_step, make_mae_train_step
from mem_tpu_torch.utils.weights import mae_classifier_from_jax_params, mae_from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MAE = dict(img_size=32, patch_size=8, in_chans=3, embed_dim=32, depth=2, num_heads=2,
            decoder_embed_dim=16, decoder_depth=1, decoder_num_heads=2)
_PP = dict(input_h=32, input_w=32, canvas_h=48, canvas_w=48, rand_aug=False, color_jitter=0.0)
LR = cosine_scheduler(1e-3, 1e-4, 1, 3)
WD = cosine_scheduler(0.05, 0.2, 1, 3)
B = 4


def _redraw(rng, tree):
    def one(path, leaf):
        base = 1.0 if "scale" in jax.tree_util.keystr(path) else 0.0
        return jnp.asarray(base + 0.1 * rng.standard_normal(leaf.shape), jnp.float32)

    return jax.device_get(jax.tree_util.tree_map_with_path(one, tree))


def _batches(rng, n, N=1200, label=False):
    out = []
    for _ in range(n):
        ev = np.zeros((B, N, 4), np.float32)
        ev[..., 0] = rng.integers(0, 48, (B, N))
        ev[..., 1] = rng.integers(0, 40, (B, N))
        ev[..., 2] = np.sort(rng.integers(0, 10**6, (B, N)), axis=1)
        ev[..., 3] = rng.choice([-1.0, 1.0], (B, N))
        b = {"events": ev, "n_valid": np.array([N, 900, 300, N], np.int32),
             "sample_h": np.array([40, 33, 40, 28], np.int32),
             "sample_w": np.array([48, 40, 31, 48], np.int32),
             "time_flip": rng.random(B) < 0.5, "x_flip": rng.random(B) < 0.5,
             "shift_xy": rng.integers(-2, 3, (B, 2)).astype(np.int32),
             "aug_seed": np.arange(B, dtype=np.uint32)}
        if label:
            b["label"] = rng.integers(0, 5, B).astype(np.int32)
        out.append(b)
    return out


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items() if k != "aug_seed"}


@pytest.mark.parametrize("norm_pix,only_masked", [(False, False), (True, True)])
def test_three_mae_steps_match_jax(rng, monkeypatch, norm_pix, only_masked):
    """f32 both sides, clip 1.0, the lr and wd schedules, each step's noise
    drawn from the JAX step's own mask key: the loss and the pre-clip grad
    norm of 3 steps to 1e-4 relative, the parameters after them to 1e-4
    relative L2 per tensor."""
    monkeypatch.setattr(jax_attention, "ENABLED", True)
    monkeypatch.setattr(jax_voxelize, "PALLAS_HIST", True)
    kw = dict(_MAE, norm_pix_loss=norm_pix, loss_only_masked=only_masked)
    fmodel = JaxMAE(**kw)
    params = _redraw(rng, jax.jit(fmodel.init)(
        {"params": jax.random.key(0), "mask": jax.random.key(1)}, jnp.zeros((1, 32, 32, 3))))
    tmodel = mae.MaskedAutoencoderViT(**kw)
    tmodel.load_state_dict(mae_from_jax_params(params), strict=True)
    batches = _batches(rng, 3)

    tx = jax_optim.create_optimizer(params, as_schedule_fn(LR), wd_schedule=as_schedule_fn(WD),
                                    weight_decay=0.05, clip_grad=1.0)
    jstep = jax_make_mae_step(fmodel, tx, JaxPreprocConfig(**_PP))
    state, want, noises = tx.init(params), [], []
    for t, b in enumerate(batches):
        key = jax.random.key(10 + t)
        noises.append(np.array(jax.random.uniform(jax.random.split(key)[0], (B, 16))))
        params, state, m = jstep(params, state, jax.tree.map(jnp.asarray, b), key)
        want.append({k: float(v) for k, v in m.items()})

    opt = optim.create_optimizer(tmodel, 1e-3, 0.05)
    tstep = make_mae_train_step(tmodel, opt, PreprocConfig(**_PP), LR, WD, 1.0)
    for t, b in enumerate(batches):
        m = tstep(_torch_batch(b), t, noise=torch.from_numpy(noises[t]))
        assert set(m) == {"loss", "grad_norm"}
        np.testing.assert_allclose(m["loss"].item(), want[t]["loss"], rtol=1e-4)
        np.testing.assert_allclose(m["grad_norm"].item(), want[t]["grad_norm"], rtol=1e-4)
    ref = mae_from_jax_params(jax.device_get(params))
    for name, p in tmodel.named_parameters():
        w = ref[name].numpy()
        assert np.linalg.norm(p.detach().numpy() - w) / np.linalg.norm(w) < 1e-4, name


def test_mae_step_draws_noise_from_its_seed(rng):
    """Without ``noise`` the step draws it from step_generator(seed, it): the
    same (seed, it) gives the same loss, another step another mask."""
    pp = PreprocConfig(**_PP)
    batch = _torch_batch(_batches(rng, 1)[0])
    losses = []
    for seed, it in ((3, 0), (3, 0), (3, 1)):
        tmodel = mae.MaskedAutoencoderViT(**_MAE)
        tmodel.init_weights(torch.Generator().manual_seed(0))
        step = make_mae_train_step(tmodel, optim.create_optimizer(tmodel, 1e-3, 0.05), pp,
                                   LR, WD, seed=seed)
        losses.append(step(batch, it)["loss"].item())
    assert losses[0] == losses[1] != losses[2]


def test_mae_classifier_finetune_step_matches_jax(rng, monkeypatch):
    """One optimizer step of vit_base_patch16's geometry at a small width
    (global pool, layer decay 0.9, EMA, label smoothing, clip 1.0, drop-path
    0, f32): loss and grad norm 1e-5 relative, parameters and the EMA 1e-4
    relative L2 per tensor."""
    monkeypatch.setattr(jax_attention, "ENABLED", True)
    monkeypatch.setattr(jax_voxelize, "PALLAS_HIST", True)
    kw = dict(img_size=(32, 32), patch_size=8, num_classes=5, embed_dim=32, depth=2,
              num_heads=2)
    fmodel = JaxMAEClassifier(**kw)
    params = _redraw(rng, jax.jit(fmodel.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 3))))
    tmodel = MAEVisionTransformer(**kw)
    tmodel.load_state_dict(mae_classifier_from_jax_params(params), strict=True)
    b = _batches(rng, 1, label=True)[0]
    pp = dict(_PP, normalize_events=True)

    tx = jax_optim.create_optimizer(params, as_schedule_fn(LR), wd_schedule=as_schedule_fn(WD),
                                    weight_decay=0.05, layer_decay=0.9, num_layers=2,
                                    clip_grad=1.0)
    jstep = jax_make_finetune_step(fmodel, tx, JaxPreprocConfig(**pp), 5, smoothing=0.1,
                                   ema_decay=0.9)
    jema = jax.tree.map(jnp.array, params)
    jparams, _, jema, want = jstep(params, tx.init(params), jema,
                                   {k: jnp.asarray(v[None]) for k, v in b.items()},
                                   jax.random.key(0))

    opt = optim.create_optimizer(tmodel, 1e-3, 0.05, layer_decay=0.9, num_layers=2)
    tema = [p.detach().clone() for p in tmodel.parameters()]
    tstep = make_finetune_train_step(tmodel, opt, PreprocConfig(**pp), 5, LR, WD,
                                     smoothing=0.1, ema=tema, ema_decay=0.9, clip_grad=1.0)
    m = tstep([_torch_batch(b)], 0)
    np.testing.assert_allclose(m["loss"].item(), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), float(want["grad_norm"]), rtol=1e-5)
    for got, tree in ((list(tmodel.parameters()), jparams), (tema, jema)):
        ref = mae_classifier_from_jax_params(jax.device_get(tree))
        for (name, _), g in zip(tmodel.named_parameters(), got):
            w = ref[name].numpy()
            assert np.linalg.norm(g.detach().numpy() - w) / np.linalg.norm(w) < 1e-4, name


# -- the chain on the CPU ----------------------------------------------------

def _write_events(tmp_path):
    rng = np.random.default_rng(0)
    root = tmp_path / "ncaltech101"
    for split, n in (("train", 8), ("val", 4)):
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
    return str(root)


_GEOMETRY = ["--input_H", "32", "--input_W", "32", "--num_layers", "3",
             "--transformer_emb", "32", "--transformer_depth", "2", "--transformer_heads", "2",
             "--max_random_shift_evs", "2", "--dtype", "float32", "--device", "cpu"]


def test_mae_chain_pretrain_finetune_serve(tmp_path, capsys):
    """run_mem_pretraining --MAE 1 (an epoch, checkpoints in the
    export_mae_params schema, an auto-resumed second) -> run_class_finetuning
    --MAE 1 --finetune (the surgery loads the encoder; an epoch with an eval
    and the EMA) -> serve --MAE 1 on its checkpoint directory (one request,
    EMA weights)."""
    from mem_tpu_torch.cli import run_class_finetuning as F
    from mem_tpu_torch.cli import run_mem_pretraining as P
    from mem_tpu_torch.cli import serve as S
    from mem_tpu_torch.cli.common import build_classifier

    root = _write_events(tmp_path)
    conf = os.path.join(REPO, "configs", "ncaltech.conf")
    pt_out, ft_out = tmp_path / "pt", tmp_path / "ft"
    pt = ["--config", conf, "--data_path", root, "--output_dir", str(pt_out), "--MAE", "1",
          "--mae_decoder_emb", "16", "--mae_decoder_depth", "1", "--mae_decoder_heads", "2",
          "--batch_size", "4", "--save_ckpt_freq", "1", "--num_workers", "0",
          "--slice_max_evs", "1500", "--warmup_steps", "1",
          "--dump_recon_dir", str(tmp_path / "dump")] + _GEOMETRY
    hist = P.main(pt + ["--epochs", "1"])
    assert [h[0] for h in hist] == [0, 1] and all(np.isfinite(h[1]) and h[2] is None
                                                  for h in hist)
    assert sorted(os.listdir(pt_out)) == ["checkpoint-0.pth", "checkpoint-final.pth"]
    assert not os.path.exists(tmp_path / "dump")            # ignored under MAE
    sd = torch.load(pt_out / "checkpoint-final.pth", weights_only=True)["model"]
    assert set(sd) == set(P.build_model(P.get_args(pt), torch.float32, "cpu").state_dict())
    assert "mask_token" in sd and "decoder_pred.weight" in sd and "pos_embed" not in sd
    assert [h[0] for h in P.main(pt + ["--epochs", "2"])] == [2, 3]
    out = capsys.readouterr().out
    assert "mlm_acc" not in out and "loss:" in out

    ft = ["--config", conf, "--data_path", root, "--output_dir", str(ft_out), "--MAE", "1",
          "--finetune", str(pt_out / "checkpoint-final.pth"), "--batch_size", "4",
          "--update_freq", "1", "--num_workers", "0", "--slice_max_evs", "1500",
          "--warmup_steps", "1", "--epochs", "1", "--save_ckpt_freq", "1",
          "--nb_classes", "2"] + _GEOMETRY
    sd = torch.load(pt_out / "checkpoint-final.pth", weights_only=True)["model"]
    args = F.get_args(ft)
    model = build_classifier(args, 2, torch.float32, "cpu")
    F.load_mae_finetune_checkpoint(model, args.finetune, args.model_key, (4, 4))
    loaded = model.state_dict()
    for k in ("blocks.1.qkv.weight", "patch_embed.weight", "cls_token"):
        assert torch.equal(loaded[k], sd[k]), k
    r = F.main(ft)
    out = capsys.readouterr().out
    assert "MAE finetuning" in out and "Load MAE PT checkpoint from" in out
    assert r["history"] and all(np.isfinite(h[1]) for h in r["history"])
    assert r["evals"][0][2] is not None
    pay = torch.load(ft_out / "checkpoint-0.pth", weights_only=True)
    assert set(pay["model"]) == set(loaded) and set(pay["ema"]) == set(loaded)

    sargs = S.get_args(["--checkpoint", str(ft_out / "checkpoint-0.pth"), "--MAE", "1",
                        "--use_ema", "1", "--nb_classes", "2", "--dataset", "ncaltech101",
                        "--slice_max_evs", "1500", "--batch_size", "2", "--max_wait_ms", "20",
                        "--topk", "2", "--port", "0"] + _GEOMETRY)
    httpd, state, threads = S.build_server(sargs)
    assert "serving ema from" in capsys.readouterr().out
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        buf = io.BytesIO()
        np.save(buf, np.load(os.path.join(root, "val", "c0", "s0.npy")))
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/predict",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = json.loads(resp.read())
    finally:
        with state.cv:
            state.stop = True
            state.cv.notify_all()
        httpd.shutdown()
        httpd.server_close()
        for th in threads:
            th.join(timeout=10)
        t.join(timeout=10)
    tk = body["topk"]
    assert len(tk) == 2 and {c for c, _ in tk} == {0, 1}
    assert abs(sum(p for _, p in tk) - 1) < 1e-5


def test_mae_with_imnet_raises():
    """--MAE 1 with --data_set IMNET is refused with the reference's words
    (run_mem_pretraining.py:337)."""
    from mem_tpu_torch.cli import run_mem_pretraining as P

    with pytest.raises(ValueError, match="not a reference path"):
        P.check_ported(P.get_args(["--data_path", "x", "--MAE", "1", "--data_set", "IMNET"]))
    P.check_ported(P.get_args(["--data_path", "x", "--MAE", "1"]))
