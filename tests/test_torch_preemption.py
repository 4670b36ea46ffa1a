"""Graceful preemption of the port's four training CLIs on the CPU (the
counterpart of tests/test_preemption.py's SIGTERM cases): a SIGTERM after
the first epoch (train_seg: after iteration 1) ends each CLI with exit 0,
``preempted at ...`` and a checkpoint, and the rerun prints ``Auto-resumed
from ... (epoch e)`` (train_seg: ``(iter i)``) and finishes; a SIGTERM during
setup, before torch is imported, still ends in a checkpoint and exit 0; the
RSS watchdog's helpers; and the pieces of ``tools/soak.py`` that need no
card (the trainer found by parent pid, the log parse, the build snapshot).
The recycle loop and the exact-resume gate are tests/test_torch_recycle.py.
"""
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_events(root, rng, files=8, lo=500, hi=900, extent=60):
    """The reference test's synthetic set: ``files`` recordings a class in
    two classes, train and val, ``lo``-``hi`` events in an extent^2 box."""
    for split in ("train", "val"):
        for cls in ("a", "b"):
            d = os.path.join(root, split, cls)
            os.makedirs(d, exist_ok=True)
            for i in range(files):
                n = int(rng.integers(lo, hi))
                ev = np.zeros((n, 4))
                ev[:, 0] = rng.integers(0, extent, n)
                ev[:, 1] = rng.integers(0, extent, n)
                ev[:, 2] = np.sort(rng.integers(0, 10**6, n))
                ev[:, 3] = rng.choice([-1.0, 1.0], n)
                np.save(os.path.join(d, f"s{i}.npy"), ev)
    return root


# the reference test's train_vae widths and flags (tests/test_preemption.py:42)
VAE_FLAGS = ["--batch_size", "8", "--num_tokens", "16", "--emb_dim", "4", "--num_layers", "2",
             "--hidden_dim", "8", "--num_resnet_blocks", "0", "--save_ckpt_freq", "1000",
             "--eval_freq", "1000", "--auto_resume", "1", "--input_H", "32", "--input_W", "32",
             "--slice_max_evs", "2000", "--max_random_shift_evs", "2", "--hotpixfilter", "0",
             "--rand_aug", "0", "--num_workers", "0", "--wandb", "0", "--dtype", "float32"]
VIT = ["--input_H", "32", "--input_W", "32", "--num_layers", "2", "--transformer_emb", "32",
       "--transformer_depth", "2", "--transformer_heads", "4"]
COMMON = ["--batch_size", "8", "--slice_max_evs", "2000", "--max_random_shift_evs", "2",
          "--hotpixfilter", "0", "--num_workers", "0", "--wandb", "0", "--dtype", "float32",
          "--auto_resume", "1", "--save_ckpt_freq", "1000", "--warmup_steps", "2"]
SEG = ["--num_classes", "3", "--seg_input_size", "64", "--embed_dim", "32", "--depth", "2",
       "--num_heads", "2", "--slice_max_evs", "25000", "--dtype", "float32", "--batch_size", "2",
       "--eval_interval", "2", "--save_interval", "1000", "--warmup_iters", "2",
       "--num_workers", "0", "--rand_aug", "0"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread for the reruns in this process: under the parallel
    runner the idle intra-op threads only spin against the other files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def child_env():
    env = dict(os.environ)
    env.update({"PYTHONPATH": REPO, "PYTHONUNBUFFERED": "1", "OMP_NUM_THREADS": "2"})
    return env


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The reference's event set, a VAE tokenizer and a pt_vit checkpoint at
    the tiny widths, and a DSEC-like seg set with ~20k-30k events a sample
    (the hot-pixel filter blanks sparser images)."""
    from PIL import Image

    from mem_tpu_torch.models.discrete_vae import DiscreteVAE
    from mem_tpu_torch.models.registry import create_model

    tmp = tmp_path_factory.mktemp("preempt")
    events = write_events(str(tmp / "caltech"), np.random.default_rng(3))
    vae = DiscreteVAE((32, 32), num_tokens=16, codebook_dim=4, num_layers=2,
                      num_resnet_blocks=0, hidden_dim=8)
    vae.init_weights(torch.Generator().manual_seed(0))
    hp = dict(input_H=32, input_W=32, num_tokens=16, emb_dim=4, num_layers=2,
              num_resnet_blocks=0, hidden_dim=8, channels=3, loss="mse")
    torch.save({"model": vae.state_dict(), "hparams": hp}, tmp / "vae.pth")
    pt = create_model("pt_vit", img_size=(32, 32), patch_size=(4, 4), embed_dim=32, depth=2,
                      num_heads=4, vocab_size=16, use_shared_rel_pos_bias=True)
    pt.init_weights(torch.Generator().manual_seed(1))
    torch.save({"model": pt.state_dict(), "epoch": 0}, tmp / "pt.pth")

    seg = tmp / "dsec"
    rng = np.random.default_rng(5)
    for split, n in (("train", 4), ("val", 1)):
        (seg / "imgs" / split / "seq0").mkdir(parents=True)
        (seg / "anns" / split / "seq0").mkdir(parents=True)
        for i in range(n):
            ne = int(rng.integers(20000, 30000))
            ev = np.zeros((ne, 4), np.float32)
            ev[:, 0] = rng.integers(0, 640, ne)
            ev[:, 1] = rng.integers(0, 480, ne)
            ev[:, 3] = rng.integers(0, 2, ne)
            np.save(seg / "imgs" / split / "seq0" / f"{i:06d}.npy", ev)
            lab = np.repeat(np.repeat(rng.integers(0, 3, (11, 16)), 40, 0), 40, 1)
            Image.fromarray(lab.astype(np.uint8)).save(
                seg / "anns" / split / "seq0" / f"{i:06d}.png")
    return {"events": events, "vae": str(tmp / "vae.pth"), "pt": str(tmp / "pt.pth"),
            "seg": str(seg)}


def cli_flags(cli, inputs, out):
    """(flags, the line after which to preempt, the run-length flag)."""
    if cli == "train_vae":
        flags = ["--data_path", inputs["events"], *VAE_FLAGS]
    elif cli == "run_mem_pretraining":
        flags = ["--data_path", inputs["events"], "--discrete_vae_weight_path", inputs["vae"],
                 *VIT, *COMMON, "--num_tokens", "16", "--num_mask_patches", "20",
                 "--mask_pool_size", "16", "--disable_eval_during_pretraining"]
    elif cli == "run_class_finetuning":
        flags = ["--data_path", inputs["events"], "--finetune", inputs["pt"], "--nb_classes", "2",
                 *VIT, *COMMON, "--disable_eval_during_finetuning"]
    else:
        flags = ["--data_root", inputs["seg"], *SEG]
        return flags + ["--output_dir", out, "--device", "cpu"], r"^\* iter 1:", "--max_iters"
    return flags + ["--output_dir", out, "--device", "cpu"], r"^epoch 0: ", "--epochs"


CLIS = ("train_vae", "run_mem_pretraining", "run_class_finetuning", "train_seg")


def _preempt_after(p, after):
    """Read ``p``'s output; SIGTERM it once a line matches ``after``.
    Returns (exit code, all its output)."""
    lines, deadline = [], time.time() + 240
    for line in p.stdout:
        lines.append(line)
        if re.match(after, line):
            p.send_signal(signal.SIGTERM)
            break
        if time.time() > deadline:
            p.kill()
            break
    rest, _ = p.communicate(timeout=240)
    return p.returncode, "".join(lines) + rest


@pytest.fixture(scope="module")
def preempted(inputs, tmp_path_factory):
    """Each CLI's first run, all four at once (each waits on its own
    process): launched with a long schedule and sent a SIGTERM once its
    first epoch (train_seg: iteration 1) is logged. {cli: (flags, run-length
    flag, exit code, output, output_dir)}."""
    from concurrent.futures import ThreadPoolExecutor

    runs = {}
    for cli in CLIS:
        out = str(tmp_path_factory.mktemp(f"preempt_{cli}") / "out")
        flags, after, length = cli_flags(cli, inputs, out)
        p = subprocess.Popen([sys.executable, "-m", f"mem_tpu_torch.cli.{cli}", *flags, length,
                              "500"], env=child_env(), cwd=REPO, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        runs[cli] = (flags, after, length, p, out)
    with ThreadPoolExecutor(len(runs)) as pool:
        done = {cli: pool.submit(_preempt_after, r[3], r[1]) for cli, r in runs.items()}
        return {cli: (runs[cli][0], runs[cli][2], *done[cli].result(), runs[cli][4])
                for cli in CLIS}


@pytest.mark.parametrize("cli", CLIS)
def test_sigterm_saves_and_resumes(cli, preempted, capsys):
    """SIGTERM once the first epoch (train_seg: iteration 1) is done: exit 0,
    ``preempted at``, the checkpoint of the interrupted epoch (iteration);
    the rerun auto-resumes there and finishes."""
    flags, length, rc, text, out = preempted[cli]
    assert rc == 0, text[-3000:]
    unit = "iter" if cli == "train_seg" else "epoch"
    m = re.search(rf"^preempted at {unit} (\d+): checkpoint saved", text, re.M)
    assert m, text[-3000:]
    at = int(m.group(1))
    assert at >= 1 and os.path.exists(os.path.join(out, f"checkpoint-{at}.pth")), text[-2000:]

    # the rerun in this process (an import of torch the fewer)
    from mem_tpu_torch.tools.resume import cli_module
    from mem_tpu_torch.utils.checkpoint import latest_numbered_checkpoint, load_checkpoint

    previous = signal.getsignal(signal.SIGTERM)
    try:
        cli_module(cli).main(flags + [length, str(at + 1)])
    finally:
        signal.signal(signal.SIGTERM, previous)
    printed = capsys.readouterr().out
    assert re.search(rf"^Auto-resumed from \S+checkpoint-{at}\.pth \({unit} {at}\)$",
                     printed, re.M), printed[-2000:]

    done = (os.path.join(out, "checkpoint-final.pth") if cli != "run_class_finetuning"
            else latest_numbered_checkpoint(out))
    assert load_checkpoint(done)["epoch"] == (at + 1 if cli == "train_seg" else at)


def test_sigterm_during_setup_is_graceful(inputs, tmp_path):
    """A SIGTERM 1 s after launch, while the CLI still imports torch, ends in
    a resumable checkpoint and exit 0, not the default disposition's 143: the
    CLI latches the signal before its heavy imports (``_signals.latch``) and
    ``GracefulShutdown`` adopts it."""
    out = str(tmp_path / "vae")
    p = subprocess.Popen([sys.executable, "-m", "mem_tpu_torch.cli.train_vae",
                          "--data_path", inputs["events"], *VAE_FLAGS, "--epochs", "500",
                          "--output_dir", out, "--device", "cpu"],
                         env=child_env(), cwd=REPO, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    time.sleep(1.0)
    p.send_signal(signal.SIGTERM)
    text, _ = p.communicate(timeout=240)
    assert p.returncode == 0, text[-3000:]
    assert "preempted at epoch 0: checkpoint saved" in text
    assert os.listdir(out) == ["checkpoint-0.pth"], text[-2000:]


def test_rss_watchdog_helpers():
    from mem_tpu_torch.tools import resume
    from mem_tpu_torch.utils.preemption import (RESTART_EXIT_CODE, rss_gb, rss_recycle_due,
                                                validate_rss_flag)

    assert RESTART_EXIT_CODE == 3 == resume.RESTART_EXIT_CODE
    assert rss_gb() > 0
    assert not rss_recycle_due(0)          # off
    assert not rss_recycle_due(10_000.0)   # far above any real RSS
    assert rss_recycle_due(1e-6)           # always above a tiny threshold
    validate_rss_flag(1.0)                 # psutil reads the resident set here


def test_soak_finds_the_trainer_by_parent_pid():
    """The soak's trainer lookup walks /proc/*/stat parent pids: the python
    grandchild of a shell, by exact pid; the resident set of that pid."""
    from mem_tpu_torch.tools import soak

    sh = subprocess.Popen(["bash", "-c", f'"{sys.executable}" -c "import time; '
                           f'time.sleep(30)"; true'])
    try:
        deadline = time.time() + 20
        while (py := soak.python_descendant(sh.pid)) is None:
            assert time.time() < deadline
            time.sleep(0.05)
        assert py != sh.pid and soak._children(sh.pid) == [py]
        with open(f"/proc/{py}/stat") as f:
            assert int(f.read().rsplit(")", 1)[1].split()[1]) == sh.pid
        assert 0 < soak.rss_gb_of(py) < 10
    finally:
        sh.kill()
        sh.wait()
    assert soak.rss_gb_of(None) is None


def test_soak_parse_and_gates():
    """The soak's parse of the port's log lines: samples/s and RSS per epoch,
    the losses, resume / recycle / preemption events and their positions in
    the loss series, the launch-to-resume and launch-to-step seconds; the
    reference's continuity gate on them."""
    from mem_tpu_torch.tools import soak

    class Seg:
        def __init__(self, label, t0, lines, rss):
            self.label, self.t0, self.lines, self.rss = label, t0, lines, rss

    a = Seg("A", 0.0, [(3.0, "model params: 86.0M\n"),
                       (9.0, "Epoch: [0] [5/6] loss: 9.0100 mlm_acc: 0.0 grad_norm: 1.0\n"),
                       (9.5, "epoch 0: 300.5 samples/sec (300.5/gpu)\n"),
                       (12.0, "Epoch: [1] [5/6] loss: 8.5000 mlm_acc: 0.0 grad_norm: 1.0\n"),
                       (12.5, "preempted at epoch 2: checkpoint saved; exiting\n")], {2: 3.25})
    b = Seg("B", 100.0, [
        (104.0, "Auto-resumed from /x/checkpoint-2.pth (epoch 2)\n"),
        (110.0, "Epoch: [2] [5/6] loss: 8.4000 mlm_acc: 0.0 grad_norm: 1.0\n"),
        (110.5, "epoch 2: 280.0 samples/sec (280.0/gpu)\n"),
        (111.0, "rss 3.3 GB > 1.0 GB: recycling process (exit 3); auto_resume continues\n"),
        (112.0, "[run_resilient] memory recycle (rc=3) — relaunching\n"),
        (117.0, "Auto-resumed from /x/checkpoint-2.pth (epoch 3)\n"),
        (120.0, "Epoch: [3] [5/6] loss: 7.9000 mlm_acc: 0.0 grad_norm: 1.0\n")], {2: None})
    p = soak.parse([a, b])
    assert p["epochs"] == [("A", 0, 300.5, 3.25), ("B", 2, 280.0, None)]
    assert p["losses"] == [9.01, 8.5, 8.4, 7.9]
    assert p["events"] == [("preempt", "A", 2, 2), ("resume", "B", 2, 2),
                           ("recycle", "B", None, 3), ("resume", "B", 3, 3)]
    assert p["launch_to_resume_s"] == [4.0, 5.0]
    assert p["launch_to_first_logged_step_s"] == [9.0, 10.0, 8.0]
    cont = soak.loss_continuity(p["losses"], [2, 3])
    assert cont["resume_jumps"] == pytest.approx([0.1, 0.5])
    assert cont["max_within_segment_loss_step"] == pytest.approx(0.51)
    assert cont["max_step_between_resumes"] == pytest.approx(0.51)
    assert cont["ok"]
    # the reference's budget takes in the resume jumps: a lone jump passes
    assert soak.loss_continuity([1.0, 1.0, 9.0, 9.0], [2])["ok"]
    assert soak.loss_continuity([1.0, 1.0, 9.0, 9.0], [2])["max_step_between_resumes"] == 0.0


def test_soak_dataset_and_build_snapshot(tmp_path, monkeypatch):
    """The soak's data are the reference soak's, draw for draw (.npz columns,
    30k-120k events on 640x480); the snapshot lists the kernel library, its
    log and libmemev by name and mtime, and nothing else."""
    from mem_tpu_torch.tools import soak

    root = soak.make_dataset(str(tmp_path / "d"), files_per_class=2, val_files=1)
    rng = np.random.default_rng(0)
    for split, n in (("train", 2), ("val", 1)):
        for c in range(2):
            for i in range(n):
                m = int(rng.integers(30000, 120000))
                x_lo, x_hi = (0, 400) if c == 0 else (240, 640)
                want = {"x": rng.integers(x_lo, x_hi, m), "y": rng.integers(0, 480, m),
                        "t": np.sort(rng.integers(0, 10**6, m)), "p": rng.integers(0, 2, m)}
                got = np.load(os.path.join(root, split, f"cls{c}", f"s{i}.npz"))
                assert {k: got[k].dtype.str for k in got} == {
                    "x": "<u2", "y": "<u2", "t": "<i8", "p": "|u1"}
                for k, v in want.items():
                    np.testing.assert_array_equal(got[k], v)
    build = tmp_path / "_build"
    build.mkdir()
    for name in ("libmem_kernels_0123456789abcdef.so", "build_0123456789abcdef.log",
                 "libmemev.so", "mlp_fwd_0123456789abcdef.77.o", "libmemev.so.12.tmp"):
        (build / name).write_text("x")
    monkeypatch.setattr(soak, "BUILD_DIR", build)
    snap = soak.build_snapshot()
    assert [n for n, _ in snap] == ["build_0123456789abcdef.log", "libmem_kernels_0123456789abcdef.so",
                                    "libmemev.so"]
    os.utime(build / "libmemev.so", ns=(1, 1))
    assert soak.build_snapshot() != snap
