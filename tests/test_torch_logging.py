"""The port's logging and profiling sinks and its checkpoint pruning, held
against the JAX package's: ``prune_checkpoints`` on ``.pth`` trees (as
tests/test_config.py holds the reference's on orbax trees), ``StepTimer``
beside the reference's on one clock, ``trace`` writing a trace file,
``maybe_wandb`` / ``TensorboardLogger`` without their packages, and the
pretraining CLI with ``--log_dir``, ``--profile_dir`` and ``--wandb 1`` on the
CPU."""
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from test_torch_train import _flags, _write_inputs

from mem_tpu_torch.utils import checkpoint as C
from mem_tpu_torch.utils import metrics, profiling


def _tree(out, tags):
    for t in tags:
        C.save_checkpoint(str(out), t, {"epoch": 0})


@pytest.mark.parametrize("relative", [False, True])
def test_prune_keeps_final_best_and_latest(tmp_path, monkeypatch, relative):
    """Final, best and the highest numbered checkpoint stay, whatever their
    modification times (checkpoint-10 is written before checkpoint-9); the
    rest and an interrupted save's .tmp go. A relative output_dir resolves
    against the current directory, as tests/test_config.py:94-110 checks."""
    out = tmp_path / "ck"
    _tree(out, [4, 10, 9, "final", "best"])
    (out / "checkpoint-11.pth.1234.tmp").write_bytes(b"partial")
    (out / "log.txt").write_text("kept")
    if relative:
        monkeypatch.chdir(tmp_path)
        C.prune_checkpoints("ck")
    else:
        C.prune_checkpoints(str(out))
    assert sorted(os.listdir(out)) == ["checkpoint-10.pth", "checkpoint-best.pth",
                                       "checkpoint-final.pth", "log.txt"]


def test_prune_same_keep_set_as_reference(tmp_path):
    """One tree of tags through both packages' prune: the same tags stay."""
    from mem_tpu.utils.checkpoint import prune_checkpoints as jax_prune

    tags = [0, 3, 25, 7, "final", "best", "x"]
    ref = tmp_path / "ref"
    ref.mkdir()
    for t in tags:                 # orbax checkpoints are directories
        (ref / f"checkpoint-{t}").mkdir()
    jax_prune(str(ref))
    port = tmp_path / "port"
    _tree(port, tags)
    C.prune_checkpoints(str(port))
    assert sorted(n[:-4] for n in os.listdir(port)) == sorted(os.listdir(ref))


def test_prune_missing_dir_and_keep_tags(tmp_path):
    C.prune_checkpoints(str(tmp_path / "none"))          # no directory: nothing to do
    out = tmp_path / "ck"
    _tree(out, [1, 2, "final", "best"])
    C.prune_checkpoints(str(out), keep_tags=("best",))
    assert sorted(os.listdir(out)) == ["checkpoint-2.pth", "checkpoint-best.pth"]


@pytest.mark.parametrize("warmup", [1, 2, 3])
def test_step_timer_matches_reference(monkeypatch, warmup):
    """The same clock readings through both StepTimers give the same rates
    (None while warming up); per_chip divides by the device count."""
    from mem_tpu.utils import profiling as jax_profiling

    ticks = [0.25 * (i + 1) for i in range(10)]
    got = []
    for mod in (profiling, jax_profiling):
        it = iter(ticks)
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(perf_counter=lambda: next(it)))
        t = mod.StepTimer(batch_size=8, warmup=warmup)
        got.append([t.step() for _ in range(6)])
    assert got[0] == got[1]
    assert got[0][:warmup] == [None] * warmup and got[0][warmup] == pytest.approx(32.0)
    assert profiling.StepTimer(8).per_chip(32.0) == 32.0 / max(torch.cuda.device_count(), 1)
    assert profiling.StepTimer(8).per_chip(None) is None


def test_trace_writes_a_trace_file(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    events = json.load(open(tmp_path / "tr" / files[0]))["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    with profiling.trace(None):                       # no directory: a no-op
        pass


def test_device_memory_stats_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert profiling.device_memory_stats() == {}


def test_maybe_wandb_none_without_the_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)      # import wandb raises
    assert metrics.maybe_wandb(True, project="p") is None
    assert metrics.maybe_wandb(False) is None


def test_tensorboard_logger_falls_back(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    tb = metrics.TensorboardLogger(str(tmp_path / "tb"))
    assert tb.writer is None
    tb.update(head="train", step=1, loss=1.0)
    tb.set_step()
    tb.flush()
    assert tb.step == 1


class _FakeWandb:
    """A stand-in module for wandb: records init and log calls."""

    def __init__(self):
        self.inits, self.logs = [], []

    def init(self, **kw):
        self.inits.append(kw)

    def log(self, d):
        self.logs.append(d)

    def Image(self, panel):
        return ("image", panel.shape)


def test_pretraining_cli_sinks(tmp_path, monkeypatch, capsys):
    """--profile_dir traces the third step, --log_dir writes a TensorBoard
    event file under log_dir + wandb_group, --wandb 1 logs train/loss and
    train/grad_norm at step 0 (every 100 steps), and the log line carries
    samples/s."""
    from mem_tpu_torch.cli import run_mem_pretraining as R

    fake = _FakeWandb()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    root, vae = _write_inputs(tmp_path)
    flags = _flags(tmp_path, root, vae) + [
        "--epochs", "1", "--profile_dir", str(tmp_path / "prof"),
        "--log_dir", str(tmp_path / "tb") + "/", "--wandb_group", "grp", "--wandb", "1",
        "--expweek", "w", "--expname", "n"]
    monkeypatch.setattr(R, "LOG_EVERY", 1)                # a log line per step
    hist = R.main(flags)
    assert len(hist) == 3
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    tb_dir = tmp_path / "tb" / "grp"
    events = [f for f in os.listdir(tb_dir) if f.startswith("events.out.tfevents")]
    assert events and os.path.getsize(tb_dir / events[0]) > 0
    assert fake.inits == [{"project": "mem_pretraining", "group": "w_n"}]
    assert fake.logs == [{"train/loss": hist[0][1], "train/grad_norm": hist[0][3], "step": 0}]
    out = capsys.readouterr().out
    assert "samples/s:" in out and "not ported" not in out


def test_finetune_and_vae_cli_wandb(tmp_path, monkeypatch):
    """run_class_finetuning logs train/loss at step 0 and val acc1 / acc5
    each epoch, train_vae the loss at step 0 and at evaluation the test
    loss, the codebook usage and the reconstruction panel (wandb.Image)."""
    from mem_tpu_torch.cli import run_class_finetuning as F
    from mem_tpu_torch.cli import train_vae as V

    root, _ = _write_inputs(tmp_path)
    fake = _FakeWandb()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    size = ["--device", "cpu", "--dtype", "float32", "--input_H", "32", "--input_W", "32",
            "--num_layers", "2", "--num_workers", "0", "--max_random_shift_evs", "2",
            "--slice_max_evs", "1500", "--epochs", "1", "--wandb", "1"]
    res = F.main(["--data_path", root, "--output_dir", str(tmp_path / "ft"),
                  "--transformer_emb", "32", "--transformer_depth", "2",
                  "--transformer_heads", "2", "--batch_size", "4", "--model_ema", "0",
                  "--warmup_epochs", "0", "--log_dir", str(tmp_path / "tb_ft") + "/", *size])
    stats = res["evals"][0][1]
    assert fake.logs[0] == {"train/loss": res["history"][0][1], "epoch": 0, "step": 0}
    assert fake.logs[-1] == {"val/acc1": stats["acc1"], "val/acc5": stats["acc5"], "epoch": 0}
    assert any(f.startswith("events.out") for f in os.listdir(tmp_path / "tb_ft" / "pt"))
    fake.logs.clear()
    hist = V.main(["--data_path", root, "--output_dir", str(tmp_path / "vae"),
                   "--num_tokens", "16", "--emb_dim", "8", "--hidden_dim", "8",
                   "--num_resnet_blocks", "1", "--batch_size", "4", "--eval_freq", "1",
                   "--num_images_save", "2", *size])
    assert fake.logs[0] == {"epoch": 0, "iter": 0, "loss": hist[0][1],
                            "lr": pytest.approx(fake.logs[0]["lr"])}
    assert fake.logs[1]["reconstructions"][0] == "image"
    assert set(fake.logs[2]) == {"test_loss", "codebook_usage", "epoch"}
