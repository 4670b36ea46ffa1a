"""The RSS-recycle path of the port on the CPU (the counterpart of
tests/test_preemption.py's recycle case) and the exact-resume gate.

- ``train_vae`` for 3 epochs through ``scripts/run_resilient.sh`` with
  ``--rss_restart_gb 0.001`` recycles twice and ends in
  ``checkpoint-final``; its sequence of events (each recycle's epoch, each
  resume's epoch, the final tag) equals the JAX package's on the reference
  test's own command, data and widths. Losses are not compared: the Gumbel
  noise comes from ``jax.random`` on one side and ``torch.Generator`` on the
  other.
- Exact resume, a check the reference does not make: a run recycled at
  every epoch boundary (in this process: ``main`` until it stops exiting 3)
  ends with every step's loss, the weights, the optimizer state and (the
  finetune's) EMA bit-equal to a run that never stopped, in f32 on the CPU,
  for ``train_vae``, ``run_mem_pretraining`` and ``run_class_finetuning``
  (mixup and EMA on).
- Each planted resume fault of ``tools/resume.py`` (the optimizer state
  dropped; the global step restarted at 0) fails that gate, while the
  reference soak's loss-continuity gate passes it.
"""
import contextlib
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_preemption import VAE_FLAGS, child_env, write_events

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: under the parallel runner the idle intra-op threads
    only spin against the other files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return write_events(str(tmp_path_factory.mktemp("recycle") / "caltech"),
                        np.random.default_rng(3))


def recycle_events(text: str, out_dir: str) -> list:
    """(kind, epoch) in the order printed: the recycles, the resumes; then the
    tags of the checkpoints left in ``out_dir`` (a directory each in the JAX
    package, beside a ``.meta.json``; a .pth each in the port)."""
    events = []
    for line in text.splitlines():
        m = re.search(r"recycling process \(exit 3\); auto_resume continues at epoch (\d+)", line)
        if m:
            events.append(("recycle", int(m.group(1))))
        m = re.match(r"Auto-resumed from \S+ \(epoch (\d+)\)", line)
        if m:
            events.append(("resume", int(m.group(1))))
    tags = sorted(m.group(1) for m in (re.fullmatch(r"checkpoint-(\w+)(\.pth)?", n)
                                        for n in os.listdir(out_dir)) if m)
    return events + [("checkpoints", tuple(tags))]


def _recycle_run(module: str, synth: str, out: str, env: dict, log, extra=()):
    return subprocess.Popen(
        ["bash", os.path.join(REPO, "scripts", "run_resilient.sh"), sys.executable, "-m", module,
         "--data_path", synth, "--output_dir", out, *VAE_FLAGS, "--epochs", "3",
         "--rss_restart_gb", "0.001", *extra],
        env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)


@pytest.fixture(scope="module")
def recycled(synth, tmp_path_factory):
    """train_vae for 3 epochs under run_resilient.sh, the port's and the JAX
    package's at once: the reference test's command (tests/test_preemption.py:136)
    and the port's with ``--device cpu``. {package: (exit code, output,
    output_dir)}."""
    jax_env = dict(os.environ)
    jax_env.update({"PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
                    "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
                    "JAX_COMPILATION_CACHE_DIR": "/tmp/jax_test_cache"})
    runs = {}
    for name, module, env, extra in (("jax", "mem_tpu.cli.train_vae", jax_env, ()),
                                     ("port", "mem_tpu_torch.cli.train_vae", child_env(),
                                      ("--device", "cpu"))):
        tmp = tmp_path_factory.mktemp(f"recycle_{name}")
        with open(tmp / "log.txt", "w") as log:
            runs[name] = (_recycle_run(module, synth, str(tmp / "vae"), env, log, extra), tmp)
    return {name: (p.wait(timeout=900), (tmp / "log.txt").read_text(), str(tmp / "vae"))
            for name, (p, tmp) in runs.items()}


def test_recycle_loop_matches_the_jax_package(recycled):
    """Exactly 2 recycles (after epochs 0 and 1; never after the last),
    ``checkpoint-final``, and the JAX package's sequence of events."""
    (rc, text, out), (jax_rc, jax_text, jax_out) = recycled["port"], recycled["jax"]
    assert rc == 0, text[-3000:]
    assert jax_rc == 0, jax_text[-3000:]
    assert text.count("recycling process (exit 3)") == 2, text[-3000:]
    assert text.count("memory recycle (rc=3)") == 2, text[-3000:]
    assert os.path.exists(os.path.join(out, "checkpoint-final.pth"))
    got, want = recycle_events(text, out), recycle_events(jax_text, jax_out)
    assert got == want
    assert got[:4] == [("recycle", 1), ("resume", 1), ("recycle", 2), ("resume", 2)]


# -- exact resume -------------------------------------------------------------

@pytest.fixture(scope="module")
def exact_inputs(tmp_path_factory):
    """12 training recordings (3 steps an epoch at B=4), a VAE tokenizer and a
    pt_vit checkpoint at the tiny widths."""
    from mem_tpu_torch.models.discrete_vae import DiscreteVAE
    from mem_tpu_torch.models.registry import create_model

    tmp = tmp_path_factory.mktemp("exact")
    rng = np.random.default_rng(0)
    root = tmp / "ncaltech101"
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
    vae = DiscreteVAE((32, 32), num_tokens=32, codebook_dim=8, num_layers=2,
                      num_resnet_blocks=1, hidden_dim=16)
    hp = dict(input_H=32, input_W=32, num_tokens=32, emb_dim=8, num_layers=2,
              num_resnet_blocks=1, hidden_dim=16, channels=3, loss="mse")
    torch.save({"model": vae.state_dict(), "hparams": hp}, tmp / "vae.pth")
    pt = create_model("pt_vit", img_size=(32, 32), patch_size=(4, 4), embed_dim=32, depth=2,
                      num_heads=4, vocab_size=32, use_shared_rel_pos_bias=True)
    pt.init_weights(torch.Generator().manual_seed(1))
    torch.save({"model": pt.state_dict(), "epoch": 0}, tmp / "pt.pth")
    return str(root), str(tmp / "vae.pth"), str(tmp / "pt.pth")


VIT = ["--num_layers", "2", "--transformer_emb", "32", "--transformer_depth", "2",
       "--transformer_heads", "4", "--warmup_steps", "2"]


def exact_flags(cli, exact_inputs):
    root, vae, pt = exact_inputs
    common = ["--config", os.path.join(REPO, "configs", "ncaltech.conf"), "--data_path", root,
              "--device", "cpu", "--dtype", "float32", "--num_workers", "0",
              "--max_random_shift_evs", "2", "--slice_max_evs", "1500", "--input_H", "32",
              "--input_W", "32", "--batch_size", "4", "--save_ckpt_freq", "1000",
              "--epochs", "3"]
    return common + {
        "train_vae": ["--num_layers", "2", "--num_tokens", "32", "--emb_dim", "8",
                      "--hidden_dim", "16", "--num_resnet_blocks", "1", "--eval_freq", "1000"],
        "run_mem_pretraining": ["--discrete_vae_weight_path", vae, *VIT, "--num_tokens", "32",
                                "--num_mask_patches", "20", "--mask_pool_size", "16",
                                "--disable_eval_during_pretraining"],
        "run_class_finetuning": ["--finetune", pt, *VIT, "--update_freq", "2",
                                 "--mixup_prob", "1.0", "--lr", "1e-3", "--model_ema", "1",
                                 "--disable_eval_during_finetuning"],
    }[cli]


def run_arm(cli, flags, out, recycle, fault=None):
    """One arm: (recycles, [[step, loss], ...], the last epoch's checkpoint)."""
    from mem_tpu_torch.tools import resume
    from mem_tpu_torch.utils.checkpoint import load_checkpoint

    module = resume.cli_module(cli)
    argv = flags + ["--output_dir", out] + (["--rss_restart_gb", "1e-9"] if recycle else [])
    # the fault inside the record: the record keeps the CLI's own steps
    with resume.plant(module, fault) if fault else contextlib.nullcontext(), \
            resume.record_steps(module) as record:
        n = resume.run_recycled(module, argv)
    return n, resume.losses(record), load_checkpoint(os.path.join(out, "checkpoint-2.pth"))


@pytest.fixture(scope="module")
def straight(exact_inputs, tmp_path_factory):
    """The arm that never stops, once per CLI."""
    cache = {}

    def get(cli):
        if cli not in cache:
            out = str(tmp_path_factory.mktemp(f"straight_{cli}"))
            cache[cli] = run_arm(cli, exact_flags(cli, exact_inputs), out, recycle=False)
        return cache[cli]
    return get


@pytest.mark.parametrize("cli", ["train_vae", "run_mem_pretraining", "run_class_finetuning"])
def test_recycled_run_is_bit_equal_to_a_straight_one(cli, exact_inputs, straight, tmp_path):
    from mem_tpu_torch.tools.resume import state_diffs

    n0, steps0, ck0 = straight(cli)
    n1, steps1, ck1 = run_arm(cli, exact_flags(cli, exact_inputs), str(tmp_path), recycle=True)
    assert (n0, n1) == (0, 2)
    assert [s for s, _ in steps0] == list(range(9)) and all(np.isfinite(v) for _, v in steps0)
    assert steps1 == steps0
    assert ck0["epoch"] == 2 and "optimizer" in ck0
    assert cli != "run_class_finetuning" or "ema" in ck0
    assert state_diffs(ck0, ck1) == []


@pytest.mark.parametrize("fault", ["no_optimizer_state", "global_step_zero"])
def test_planted_resume_fault_fails_the_exact_gate(fault, exact_inputs, straight, tmp_path):
    """Each planted fault moves the losses after the first resume and the
    final state, so the exact gate fails; the reference soak's continuity
    gate, over the same losses and resume positions, passes both."""
    from mem_tpu_torch.tools.resume import loss_continuity, state_diffs

    cli = "run_mem_pretraining"
    _, steps0, ck0 = straight(cli)
    n, steps1, ck1 = run_arm(cli, exact_flags(cli, exact_inputs), str(tmp_path), recycle=True,
                             fault=fault)
    assert n == 2 and [s for s, _ in steps1] == [s for s, _ in steps0]
    assert steps1[:3] == steps0[:3]          # the first process is untouched
    assert steps1[3:] != steps0[3:]
    assert any(d.startswith(".model.") for d in state_diffs(ck0, ck1))
    cont = loss_continuity([v for _, v in steps1], [3, 6])
    assert cont["ok"], cont
