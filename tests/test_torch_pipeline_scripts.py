"""The port's pipeline scripts end to end on the CPU, mirroring
tests/test_e2e_smoke.py:246-300 (run-pipeline.sh) and
tests/test_segmentation.py:200-250 (run-ss.sh): one tiny .conf with
``device = cpu`` through run-pipeline-torch.sh (VAE -> pretraining ->
finetune, pruned to final / best / latest) and run-ss-torch.sh (seg
training -> the per-class table), each stage a ``python -m
mem_tpu_torch.cli.*`` process that imports nothing of JAX."""
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, *args):
    env = dict(os.environ, PYTHONPATH=REPO, PYTHON=sys.executable)
    r = subprocess.run(["bash", os.path.join(REPO, script), *map(str, args)], env=env,
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


@pytest.fixture(scope="module")
def synth_dataset(tmp_path_factory):
    """tests/test_e2e_smoke.py's two-class set: class A's events left, B's
    right."""
    root = tmp_path_factory.mktemp("synth")
    rng = np.random.default_rng(7)
    for split, n_per in (("train", 12), ("val", 4)):
        for ci, cls in enumerate(["left", "right"]):
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(n_per):
                n = int(rng.integers(800, 1500))
                x_lo, x_hi = (5, 30) if ci == 0 else (34, 59)
                ev = np.zeros((n, 4))
                ev[:, 0] = rng.integers(x_lo, x_hi, n)
                ev[:, 1] = rng.integers(5, 59, n)
                ev[:, 2] = np.sort(rng.integers(0, 10**6, n))
                ev[:, 3] = rng.choice([-1.0, 1.0], n)
                np.save(d / f"s{i}.npy", ev)
    return str(root)


def test_run_pipeline_torch(synth_dataset, tmp_path):
    """One .conf -> VAE -> pretraining -> finetune on the port, the stage
    checkpoints handed on as .pth files and pruned; the optional keys
    (vae_skip, vae_checkpoint, ...) absent, as in the reference's test; a
    profile_dir key traces the pretraining stage's third step (the conf
    steps one at a time: test_run_pipeline_torch_chained chains)."""
    _pipeline(synth_dataset, tmp_path, "steps_per_dispatch = 1\n")


def test_run_pipeline_torch_chained(synth_dataset, tmp_path):
    """The same pipeline with ``steps_per_dispatch = 3`` in the conf and a
    pretraining batch of 2 (12 steps an epoch, four chunks): every stage
    chains, and profile_dir traces the pretraining stage's third chunk."""
    log = _pipeline(synth_dataset, tmp_path, "steps_per_dispatch = 3\n",
                    pt_batch_size=2)
    assert log.count("chain: eager K=3 (device cpu)") == 3


def _pipeline(synth_dataset, tmp_path, extra: str, pt_batch_size: int = 8) -> str:
    conf = tmp_path / "pipe.conf"
    expdir = tmp_path / "exp"
    conf.write_text(
        extra +
        "expweek = t\nexpname = pipe\ndevice = cpu\n"
        f"profile_dir = {expdir}/profile\n"
        f"data_path = {synth_dataset}\n"
        "input_H = 32\ninput_W = 32\nslice_max_evs = 5000\n"
        "hotpixfilter = 0\nnormalize_events = 1\nrand_aug = 0\n"
        "max_random_shift_evs = 2\nnum_workers = 0\nwandb = 0\n"
        "dtype = float32\nauto_resume = 0\n"
        "num_layers = 2\nnum_tokens = 32\nemb_dim = 8\nhidden_dim = 16\n"
        "num_resnet_blocks = 1\n"
        "vae_epochs = 2\nvae_batch_size = 8\nlearning_rate = 3e-4\n"
        "clip = 0.01\neval_freq = 10\nvae_save_ckpt_freq = 1\n"
        "transformer_emb = 32\ntransformer_depth = 2\ntransformer_heads = 2\n"
        "num_mask_patches = 32\nmin_mask_patches_per_block = 4\nmask_pool_size = 16\n"
        f"pt_epochs = 2\npt_batch_size = {pt_batch_size}\npt_lr = 1e-3\nwarmup_epochs = 0\n"
        "save_ckpt_freq = 1\n"
        "class_epochs = 2\nclass_batch_size = 8\nclass_lr = 2e-3\n"
        "class_warmup_epochs = 0\nclass_update_freq = 1\nmixup_prob = 0\n"
        "class_save_ckpt_freq = 1\n")
    out = _run("run-pipeline-torch.sh", conf, expdir)
    for stage in ("vae", "pretrain"):
        # two numbered checkpoints were written: the newest and final stay
        assert sorted(os.listdir(expdir / stage)) == ["checkpoint-1.pth",
                                                      "checkpoint-final.pth"], stage
    # the finetune stage tags epochs and best, no final
    ft = sorted(os.listdir(expdir / "finetune"))
    assert ft == ["checkpoint-1.pth", "checkpoint-best.pth"], ft
    assert (expdir / "config.conf").read_text() == conf.read_text()
    log = (expdir / "logs" / "log.txt").read_text()
    assert "== pipeline done" in out and "device cpu" in log and "Traceback" not in log
    # the conf's profile_dir reached the pretraining stage: its third step's
    # (chunk's) trace
    traces = os.listdir(expdir / "profile")
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    return log


def test_run_ss_torch(tmp_path):
    """.conf -> train_seg -> the pruned seg directory -> test_seg's per-class
    table, on the CPU through the conf's ``device = cpu``."""
    from PIL import Image

    root = tmp_path / "dsec"
    rng = np.random.default_rng(5)
    for split, n in (("train", 4), ("val", 2)):
        (root / "imgs" / split / "seq0").mkdir(parents=True)
        (root / "anns" / split / "seq0").mkdir(parents=True)
        for i in range(n):
            ne = int(rng.integers(20000, 30000))
            ev = np.zeros((ne, 4), np.float32)
            ev[:, 0] = rng.integers(0, 640, ne)
            ev[:, 1] = rng.integers(0, 480, ne)
            ev[:, 3] = rng.integers(0, 2, ne)
            np.save(root / "imgs" / split / "seq0" / f"{i:06d}.npy", ev)
            lab = rng.integers(0, 3, (440, 640)).astype(np.uint8)
            lab[:10] = 255
            Image.fromarray(lab).save(root / "anns" / split / "seq0" / f"{i:06d}.png")
    conf = tmp_path / "seg.conf"
    conf.write_text(
        "expweek = test\nexpname = ss\ndevice = cpu\n"
        f"data_root = {root}\n"
        "num_classes = 3\nseg_input_size = 64\nembed_dim = 32\ndepth = 2\nnum_heads = 2\n"
        "max_iters = 2\nbatch_size = 2\nlr = 1e-3\nwarmup_iters = 1\n"
        "eval_interval = 1000\nsave_interval = 1\nrand_aug = 0\nslice_max_evs = 25000\n"
        "auto_resume = 0\ndtype = float32\naug_test = 0\nnum_workers = 1\n")
    expdir = tmp_path / "exp"
    out = _run("run-ss-torch.sh", conf, expdir)
    # iterations 0 and 1 were saved: the newest numbered one and final stay
    assert sorted(os.listdir(expdir / "seg")) == ["checkpoint-1.pth", "checkpoint-final.pth"]
    assert "mIoU" in out and "== seg pipeline done" in out
    rows = [ln for ln in out.splitlines() if ln[:1].isdigit() and len(ln.split()) == 3]
    assert len(rows) == 3
