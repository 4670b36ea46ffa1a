"""The port's parallel/ package against the JAX package's: the spec rules
(tp_param_specs on pt_vit and on the MAE's and its classifier's ViT-B,
zero1_opt_specs, fsdp_specs pick the same dimensions on the same shapes),
the refused placement combinations (and every optimizer placed under FSDP
and TP, as the JAX package places any), the per-process batch and
the IMNET pipeline's shard of each epoch; and the five training and eval
CLIs under two Gloo processes (one launch of the worker's ``cli`` mode:
run_mem_pretraining with --fsdp 1, --zero1 1 (resuming a single-process
checkpoint) and --tp 2, run_class_finetuning --zero1 1, train_vae,
train_seg and test_seg), whose checkpoints are the single-process schema and
resume in one process."""
import json
import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the spec rules ---------------------------------------------------------------

def _pt_params():
    from mem_tpu.models import create_model

    model = create_model("pt_vit", vocab_size=32, img_size=(32, 32), patch_size=(8, 8),
                         embed_dim=32, depth=2, num_heads=2, dtype=jnp.float32)
    x = jnp.zeros((1, 32, 32, 3))
    return jax.device_get(jax.jit(model.init)(jax.random.key(0), x, jnp.zeros((1, 16), bool)))


def _varying_dims(t: np.ndarray) -> list:
    return [i for i in range(t.ndim) if t.shape[i] > 1 and np.any(np.diff(t, axis=i) != 0)]


def test_tp_param_specs_pick_the_reference_dims():
    """Each flax leaf is filled with values that vary only along the dim
    JAX's tp_param_specs shards (constant where replicated); carried into
    the port's names and layouts by from_jax_params, the varying dim is the
    one the port's spec shards, for every parameter. (The port cuts q, k, v
    by head where the reference's spec cuts the packed columns: the same
    dimension.)"""
    from jax.sharding import PartitionSpec as P

    from mem_tpu.parallel.mesh import tp_param_specs as jax_specs
    from mem_tpu_torch.parallel.mesh import tp_param_specs
    from mem_tpu_torch.utils.weights import from_jax_params

    params = _pt_params()
    specs = jax_specs(params)

    def tag(leaf, spec):
        shape = np.shape(leaf)
        dims = [i for i, a in enumerate(tuple(spec)) if a == "model"]
        if not dims:
            return np.zeros(shape, np.float32)
        d = dims[0]
        return np.broadcast_to(np.arange(shape[d], dtype=np.float32).reshape(
            [-1 if i == d else 1 for i in range(len(shape))]), shape).copy()

    tagged = jax.tree.map(tag, params, specs, is_leaf=lambda x: isinstance(x, P))
    port = from_jax_params(tagged)
    got = tp_param_specs(port)
    n_sharded = 0
    for name, t in port.items():
        want = _varying_dims(t.numpy())
        mine = [i for i, a in enumerate(got[name]) if a == "model"]
        assert mine == want, (name, mine, want)
        n_sharded += bool(mine)
    assert n_sharded == 2 * 7    # qkv, q_bias, v_bias, proj, fc1 (w, b), fc2 a block


def _tagged_tiny(shapes, specs):
    """A (2,)*ndim leaf per flax leaf, varying only along the dim its spec
    puts on "model": the names and layouts of the full model without its
    memory."""
    from jax.sharding import PartitionSpec as P

    def tag(leaf, spec):
        dims = [i for i, a in enumerate(tuple(spec)) if a == "model"]
        shape = (2,) * len(leaf.shape)
        if not dims:
            return np.zeros(shape, np.float32)
        return np.broadcast_to(np.arange(2, dtype=np.float32).reshape(
            [-1 if i == dims[0] else 1 for i in range(len(shape))]), shape).copy()

    return jax.tree.map(tag, shapes, specs, is_leaf=lambda x: isinstance(x, P))


@pytest.mark.parametrize("which", ["mae_vit_base_patch16_dec512d8b", "vit_base_patch16"])
def test_tp_param_specs_pick_the_reference_dims_on_the_mae(which):
    """The reference's rule on the MAE's names (its _TimmBlock has no
    ``attn`` scope: every block's fc1 cut on its output dim and fc2 on its
    input dim, qkv and proj whole), on the full ViT-B MAE (a 512-wide,
    8-block decoder) and its finetune classifier: carried into the port's
    names and layouts by the MAE converters, the dim the JAX spec shards is
    the one the port's spec shards, for every parameter of the port's
    model."""
    from mem_tpu.models.registry import create_model as jax_create
    from mem_tpu.parallel.mesh import tp_param_specs as jax_specs
    from mem_tpu_torch.models.registry import create_model
    from mem_tpu_torch.parallel.mesh import tp_param_specs
    from mem_tpu_torch.utils.weights import mae_classifier_from_jax_params, mae_from_jax_params

    fmodel = jax_create(which, dtype=jnp.float32)
    rngs = {"params": jax.random.key(0), "mask": jax.random.key(1)}
    shapes = jax.eval_shape(fmodel.init, rngs if which.startswith("mae") else rngs["params"],
                            jnp.zeros((1, 224, 224, 3)))
    convert = mae_from_jax_params if which.startswith("mae") else mae_classifier_from_jax_params
    port = convert(_tagged_tiny(shapes, jax_specs(shapes)))
    tmodel = create_model(which, device="meta")
    assert set(port) == {k for k, _ in tmodel.named_parameters()}
    got = tp_param_specs(port)
    n_sharded = 0
    for name, t in port.items():
        want = _varying_dims(t.numpy())
        mine = [i for i, a in enumerate(got[name]) if a == "model"]
        assert mine == want, (name, mine, want)
        n_sharded += bool(mine)
        assert not mine or name.rsplit(".", 2)[-2] in ("fc1", "fc2"), name
    assert n_sharded == 3 * (20 if which.startswith("mae") else 12)   # fc1 (w, b), fc2 a block


def _shape_tree():
    """The pt_vit params, an Adam-like state over them, odd shapes and a
    scalar: the leaves the rules see in the reference."""
    params = _pt_params()["params"]
    return {"params": params, "mu": params, "count": np.zeros((), np.int32),
            "odd": np.zeros((7, 3), np.float32), "tie": np.zeros((16, 16), np.float32)}


@pytest.mark.parametrize("rule", ["zero1_opt_specs", "fsdp_specs"])
@pytest.mark.parametrize("n", [2, 8])
def test_data_spec_rules_match_the_reference(rule, n):
    """ZeRO-1 (the leading dim when it divides the axis) and FSDP (the
    largest dividing dim, ties to the first) on the same shapes."""
    from mem_tpu.parallel import mesh as jax_mesh
    from mem_tpu.parallel import get_mesh
    from mem_tpu_torch.parallel import mesh as port_mesh

    tree = _shape_tree()
    mesh = get_mesh(devices=jax.devices()[:n])
    want = getattr(jax_mesh, rule)(tree, mesh)
    got = getattr(port_mesh, rule)(tree, n)
    flat_want = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got, is_leaf=lambda x: isinstance(x, tuple))[0])
    assert len(flat_want) == len(flat_got)
    for path, spec in flat_want:
        assert tuple(spec) == flat_got[path], (jax.tree_util.keystr(path), spec)


def test_place_train_state_rejects_the_reference_combinations():
    """The modes are exclusive (ValueError "placement mode", as
    place_train_state in the JAX package) and --tp needs a process group;
    nothing else is refused: every --opt, with and without ``lookahead_``,
    places under FSDP and under TP (on a world-size-1 Gloo group here; the
    two-rank updates are test_torch_multiprocess.py's), and --MAE 1 takes
    --tp, as the JAX package places any optimizer state on any mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from mem_tpu.parallel import get_mesh
    from mem_tpu.parallel.mesh import place_train_state as jax_place
    from mem_tpu_torch.cli import run_mem_pretraining as R
    from mem_tpu_torch.models.registry import create_model
    from mem_tpu_torch.parallel import mesh as port_mesh
    from mem_tpu_torch.parallel.mesh import place_tensor_parallel, place_train_state
    from mem_tpu_torch.tools.mp_worker import free_port
    from mem_tpu_torch.train.optim import OPTIMIZERS, create_optimizer

    w = {"w": jnp.zeros((8, 8), jnp.float32)}
    model = create_model("pt_vit", img_size=(32, 32), patch_size=(8, 8), embed_dim=32, depth=1,
                         num_heads=2, vocab_size=32)
    opt = create_optimizer(model, 1e-3, 0.05)
    for kw in (dict(tp=2, fsdp=True), dict(zero1=True, fsdp=True), dict(tp=2, zero1=True)):
        with pytest.raises(ValueError, match="placement mode"):
            jax_place(w, w, get_mesh(), **kw)
        with pytest.raises(ValueError, match="placement mode"):
            place_train_state(model, opt, None, **kw)
    with pytest.raises(ValueError, match="process group"):
        place_train_state(model, opt, None, tp=2)
    assert place_train_state(model, opt, None).mode == "single"
    assert not hasattr(port_mesh, "check_optimizer")
    R.check_ported(R.get_args(["--MAE", "1", "--tp", "2"]))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        names = list(OPTIMIZERS) + [f"lookahead_{n}" for n in OPTIMIZERS]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for name in names:
                for kind in ("fsdp", "tp"):
                    model = create_model("pt_vit", img_size=(32, 32), patch_size=(8, 8),
                                         embed_dim=32, depth=1, num_heads=2, vocab_size=32)
                    opt = create_optimizer(model, 1e-3, 0.05, opt=name)
                    if kind == "fsdp":
                        placed = place_train_state(model, opt, port_mesh.get_mesh(), fsdp=True)
                    else:
                        placed = place_tensor_parallel(model, opt, init_device_mesh(
                            "cpu", (1, 1), mesh_dim_names=("data", "model")))
                    assert placed.mode == kind, (name, kind)
    finally:
        dist.destroy_process_group()


def test_one_process_batch_and_mesh():
    """Without a process group: no mesh, the global batch is the process's,
    and shard_batch moves a host batch as it is."""
    from mem_tpu_torch.parallel import get_mesh, local_batch_size, shard_batch

    assert get_mesh() is None
    assert local_batch_size(12) == 12
    b = shard_batch({"x": np.arange(6).reshape(3, 2)}, None, global_batch=True)
    assert torch.equal(b["x"], torch.arange(6).reshape(3, 2))


@pytest.mark.parametrize("is_train", [True, False])
def test_image_pipeline_shards_match_the_reference(is_train):
    """shard_id::num_shards of each epoch's shuffled indices, as
    mem_tpu/data/image_pipeline.py:178 takes them; the shards partition the
    epoch."""
    from mem_tpu.data.image_pipeline import (ImageBatchIterator as JaxIt,
                                             ImagePipelineConfig as JaxCfg)
    from mem_tpu_torch.data.image_pipeline import ImageBatchIterator, ImagePipelineConfig

    class Folder:
        samples = []

        def __len__(self):
            return 23

    for epoch in (0, 3):
        seen = []
        for shard in range(3):
            kw = dict(seed=7, is_train=is_train, shuffle=is_train, masking=None,
                      shard_id=shard, num_shards=3)
            mine = ImageBatchIterator(Folder(), ImagePipelineConfig(**kw))._epoch_indices(epoch)
            theirs = JaxIt(Folder(), JaxCfg(**kw))._epoch_indices(epoch)
            np.testing.assert_array_equal(mine, theirs)
            seen += list(mine)
        assert sorted(seen) == list(range(23))


# -- the CLIs under two processes ----------------------------------------------------

def _write_event_data(root):
    rng = np.random.default_rng(0)
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


def _write_seg_data(root):
    from PIL import Image

    rng = np.random.default_rng(5)
    for split in ("train", "val"):
        (root / "imgs" / split / "seq0").mkdir(parents=True)
        (root / "anns" / split / "seq0").mkdir(parents=True)
        for i in range(4):
            ne = int(rng.integers(20000, 26000))
            ev = np.zeros((ne, 4), np.float32)
            ev[:, 0] = rng.integers(0, 640, ne)
            ev[:, 1] = rng.integers(0, 480, ne)
            ev[: ne // 2, 0] = np.clip(rng.normal(200 + 60 * i, 60, ne // 2), 0, 639).astype(int)
            ev[:, 3] = rng.integers(0, 2, ne)
            np.save(root / "imgs" / split / "seq0" / f"{i:06d}.npy", ev)
            lab = np.repeat(np.repeat(rng.integers(0, 3, (11, 16)), 40, 0), 40, 1).astype(np.uint8)
            lab[: 10 + 100 * (i % 2)] = 255
            Image.fromarray(lab).save(root / "anns" / split / "seq0" / f"{i:06d}.png")


_MAE_FLAGS = ["--MAE", "1", "--mae_decoder_emb", "16", "--mae_decoder_depth", "1",
              "--mae_decoder_heads", "2"]
_EV = ["--device", "cpu", "--input_H", "32", "--input_W", "32", "--num_layers", "2",
       "--batch_size", "4", "--num_workers", "0", "--max_random_shift_evs", "2",
       "--slice_max_evs", "1500", "--save_ckpt_freq", "1"]
_SEG = ["--num_classes", "3", "--seg_input_size", "64", "--embed_dim", "32", "--depth", "2",
        "--num_heads", "2", "--slice_max_evs", "25000", "--dtype", "float32", "--device", "cpu"]


def _pt_flags(tmp, out):
    return ["--config", os.path.join(REPO, "configs", "ncaltech.conf"),
            "--data_path", str(tmp / "ncaltech101"), "--discrete_vae_weight_path",
            str(tmp / "vae.pth"), "--output_dir", str(tmp / out), *_EV, "--dtype", "float32",
            "--transformer_emb", "32", "--transformer_depth", "2", "--transformer_heads", "4",
            "--num_tokens", "32", "--num_mask_patches", "20", "--mask_pool_size", "16",
            "--warmup_steps", "2"]


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The inputs, a single-process pretraining epoch (the checkpoint the
    --zero1 run resumes), then the ``cli`` launch."""
    from mem_tpu_torch.cli import run_mem_pretraining
    from mem_tpu_torch.models.discrete_vae import DiscreteVAE
    from mem_tpu_torch.tools import mp_worker

    tmp = tmp_path_factory.mktemp("mp_cli")
    _write_event_data(tmp / "ncaltech101")
    _write_seg_data(tmp / "dsec")
    vae = DiscreteVAE((32, 32), num_tokens=32, codebook_dim=8, num_layers=2,
                      num_resnet_blocks=1, hidden_dim=16)
    hp = dict(input_H=32, input_W=32, num_tokens=32, emb_dim=8, num_layers=2,
              num_resnet_blocks=1, hidden_dim=16, channels=3, loss="mse")
    torch.save({"model": vae.state_dict(), "hparams": hp}, tmp / "vae.pth")
    run_mem_pretraining.main(_pt_flags(tmp, "pt_zero1") + ["--epochs", "1"])
    seg_common = ["--data_root", str(tmp / "dsec"), *_SEG, "--num_workers", "0"]
    plan = {
        "pt_fsdp": ["run_mem_pretraining", _pt_flags(tmp, "pt_fsdp") + ["--fsdp", "1",
                                                                        "--epochs", "1"]],
        "pt_zero1": ["run_mem_pretraining", _pt_flags(tmp, "pt_zero1") + ["--zero1", "1",
                                                                          "--epochs", "2"]],
        "pt_tp": ["run_mem_pretraining", _pt_flags(tmp, "pt_tp") + ["--tp", "2",
                                                                    "--epochs", "1"]],
        "pt_mae_tp": ["run_mem_pretraining", _pt_flags(tmp, "pt_mae_tp") + _MAE_FLAGS + [
            "--tp", "2", "--opt", "lookahead_adafactor", "--epochs", "1"]],
        "ft_zero1": ["run_class_finetuning", [
            "--config", os.path.join(REPO, "configs", "ncaltech.conf"), "--data_path",
            str(tmp / "ncaltech101"), "--finetune", str(tmp / "pt_zero1" / "checkpoint-0.pth"),
            "--output_dir", str(tmp / "ft"), *_EV, "--dtype", "float32", "--transformer_emb",
            "32", "--transformer_depth", "2", "--transformer_heads", "4", "--update_freq", "2",
            "--warmup_steps", "2", "--zero1", "1", "--epochs", "1"]],
        "vae": ["train_vae", [
            "--config", os.path.join(REPO, "configs", "ncaltech.conf"), "--data_path",
            str(tmp / "ncaltech101"), "--output_dir", str(tmp / "vae_out"), *_EV,
            "--dtype", "float32", "--num_tokens", "32", "--emb_dim", "8", "--hidden_dim", "16",
            "--num_resnet_blocks", "1", "--eval_freq", "1", "--epochs", "1"]],
        "seg": ["train_seg", seg_common + ["--batch_size", "2", "--output_dir",
                                           str(tmp / "seg"), "--max_iters", "2",
                                           "--eval_interval", "2", "--save_interval", "2",
                                           "--warmup_iters", "1"]],
        "test_seg": ["test_seg", seg_common + ["--batch_size", "2", "--checkpoint",
                                               str(tmp / "seg" / "checkpoint-final.pth")]],
    }
    (tmp / "work").mkdir()
    with open(tmp / "work" / "cli_flags.json", "w") as f:
        json.dump(plan, f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    outs = mp_worker.launch("cli", str(tmp / "work"), 2, env=env, timeout=400, cwd=REPO)
    for rank, (code, log) in enumerate(outs):
        assert code == 0, f"rank {rank} exit {code}\n{log[-5000:]}"
    with open(tmp / "work" / "ok_cli_r0.json") as f:
        done = json.load(f)["clis"]
    return tmp, plan, done, [log for _, log in outs]


def _single_model_keys(tmp, extra=()):
    from mem_tpu_torch.cli import run_mem_pretraining as R

    args = R.get_args(_pt_flags(tmp, "x") + list(extra))
    m = R.build_model(args, torch.float32, torch.device("cpu"))
    return {k: tuple(v.shape) for k, v in m.state_dict().items()}


@pytest.mark.parametrize("run", ["pt_fsdp", "pt_tp", "pt_zero1"])
def test_two_process_pretraining_writes_the_single_process_schema(cli_run, run):
    """Rank 0's checkpoints hold the single-process state_dict (FSDP and TP
    gathered, no ``module.`` prefix) and a whole optimizer state (ZeRO-1's
    partitions merged, FSDP's and TP's moments gathered)."""
    tmp, _, done, logs = cli_run
    assert run in done
    payload = torch.load(tmp / run / "checkpoint-final.pth", weights_only=True)
    want = _single_model_keys(tmp)
    assert {k: tuple(v.shape) for k, v in payload["model"].items()} == want
    n_params = len([k for k in want if "running_" not in k])
    state = payload["optimizer"]["state"]
    assert len(state) == n_params
    shapes = sorted(tuple(s["exp_avg"].shape) for s in state.values())
    assert shapes == sorted(want[k] for k in want if "running_" not in k)
    assert any("samples/sec" in log and "/gpu)" in log for log in logs)


def test_two_process_mae_tp_writes_the_single_process_schema(cli_run):
    """run_mem_pretraining --MAE 1 --tp 2 (each rank half of every timm
    block's MLP hidden columns) with Lookahead over Adafactor: rank 0's
    checkpoint holds the single-process MAE state_dict, the whole moments
    and the whole slow weights, and resumes in one process."""
    from mem_tpu_torch.cli import run_mem_pretraining as R

    tmp, _, done, _ = cli_run
    assert "pt_mae_tp" in done
    payload = torch.load(tmp / "pt_mae_tp" / "checkpoint-final.pth", weights_only=True)
    want = _single_model_keys(tmp, _MAE_FLAGS)
    assert {k: tuple(v.shape) for k, v in payload["model"].items()} == want
    opt = payload["optimizer"]
    assert sorted(tuple(s.shape) for s in opt["lookahead_slow"]) == sorted(want.values())
    assert sorted(tuple(s["v"].shape) for s in opt["inner"]["state"].values()) == sorted(
        want.values())
    hist = R.main(_pt_flags(tmp, "pt_mae_tp") + _MAE_FLAGS + ["--opt", "lookahead_adafactor",
                                                              "--epochs", "2"])
    assert [h[0] for h in hist] == [3, 4, 5] and all(np.isfinite(h[1]) for h in hist)


def test_fsdp_checkpoint_resumes_in_one_process(cli_run):
    """The two-process FSDP run's checkpoint continues in one process."""
    from mem_tpu_torch.cli import run_mem_pretraining as R

    tmp, _, _, _ = cli_run
    hist = R.main(_pt_flags(tmp, "pt_fsdp") + ["--epochs", "2"])
    assert [h[0] for h in hist] == [3, 4, 5] and all(np.isfinite(h[1]) for h in hist)


def test_zero1_run_resumed_a_single_process_checkpoint(cli_run):
    """The --zero1 1 run started from this process's epoch-0 checkpoint: its
    epoch-1 checkpoint exists, the epoch-0 one is this process's."""
    tmp, _, _, logs = cli_run
    assert (tmp / "pt_zero1" / "checkpoint-1.pth").exists()
    assert sum("Auto-resumed from" in log and "pt_zero1" in log for log in logs) == 2
    assert torch.load(tmp / "pt_zero1" / "checkpoint-1.pth", weights_only=True)["epoch"] == 1


def test_finetune_vae_and_seg_clis_ran_under_two_processes(cli_run):
    """run_class_finetuning --zero1 1 (with its EMA), train_vae and train_seg
    checkpoints in the single-process schema."""
    from mem_tpu_torch.utils.checkpoint import latest_numbered_checkpoint

    tmp, _, done, _ = cli_run
    assert {"ft_zero1", "vae", "seg"} <= set(done)
    ft = torch.load(latest_numbered_checkpoint(str(tmp / "ft")), weights_only=True)
    assert set(ft["ema"]) == {k for k in ft["model"] if "running_" not in k}
    assert len(ft["optimizer"]["state"]) == len(ft["ema"])
    vae = torch.load(tmp / "vae_out" / "checkpoint-final.pth", weights_only=True)
    assert "hparams" in vae and "encoder.0.0.weight" in vae["model"]
    seg = torch.load(tmp / "seg" / "checkpoint-final.pth", weights_only=True)
    assert any(k.endswith("running_var") for k in seg["model"])


def test_two_process_test_seg_sums_the_confusion_matrices(cli_run):
    """test_seg over two processes (each half of the val split) reports the
    mIoU of one process over the whole split."""
    from mem_tpu_torch.cli import test_seg

    tmp, plan, done, _ = cli_run
    stats = test_seg.main(plan["test_seg"][1])
    assert done["test_seg"]["mIoU"] == pytest.approx(stats["mIoU"], rel=1e-6)
    assert done["test_seg"]["aAcc"] == pytest.approx(stats["aAcc"], rel=1e-6)
