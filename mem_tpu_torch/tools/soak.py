"""Preemption and endurance soak of the port on the card: the counterpart of
scripts/soak_pretrain.py.

Drives a synthetic N-ImageNet-shaped ViT-B MEM pretraining (``pt_vit``,
B=128, 224^2) through ``scripts/run_resilient.sh`` and injects the failure
menu mid-run:

  segment A: ordinary training, ended by a SIGTERM (graceful preemption: a
             checkpoint and exit 0, the requeue path);
  segment B: relaunched with ``--rss_restart_gb 1.0``, so every epoch
             boundary trips the RSS watchdog (exit 3) and run_resilient.sh
             relaunches in place; ended by a second SIGTERM;
  segment C: relaunched clean, runs to the time budget, ended by a last
             SIGTERM.

Each SIGTERM goes to the python descendant of the wrapper, found by parent
pid in ``/proc/*/stat`` (exact pids, never name patterns; a SIGKILL is
never sent). A segment is preempted at its share of ``--minutes``, but not
within :data:`SETTLE_S` of its trainer's start or after the trainer has
announced a recycle, and segment B not before its first recycle.

Gates (``soak.json`` ``gates``; the exit code is 1 when one fails):

- at least 2 preemptions, each exiting 0 with its checkpoint written;
- at least 1 recycle and at least 3 auto-resumes;
- the reference's loss continuity, ``max_resume_jump <= max(within, 0.5)``
  over the logged losses (``tools/resume.py`` ``loss_continuity``);
- no kernel rebuilt after segment A: the file names and mtimes of
  ``mem_tpu_torch/_build/`` (``libmem_kernels_<hash>.so``,
  ``build_<hash>.log``, ``libmemev.so``) do not change after it.

Recorded beside them: samples/s and the trainer's resident set (read from
``/proc/<pid>/status`` when its epoch line arrives) per epoch across
restarts, the seconds from each SIGTERM to the wrapper's exit, and from each
launch to the trainer's resume line and to its first logged step.

The soak's own process imports no torch: the children run on the card through the CLIs'
default device. ``--record f.jsonl`` runs each trainer through
``tools/resume.py`` instead, which appends its steps and kernel launch
counts to ``f.jsonl``. Reports: ``<workdir>/soak.json``, ``soak.log`` and
the markdown report ``--out`` (default ``<workdir>/SOAK.md``).

Usage, from the repo root:
    python -m mem_tpu_torch.tools.soak [--minutes 90] [--workdir soak_work]
"""
from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from mem_tpu_torch.tools.resume import loss_continuity
from mem_tpu_torch.utils.checkpoint import prune_checkpoints

REPO = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO / "mem_tpu_torch" / "_build"
BUILD_FILES = re.compile(r"libmem_kernels_[0-9a-f]+\.so|build_[0-9a-f]+\.log|libmemev\.so")

CHILD_ENV = {**os.environ, "PYTHONUNBUFFERED": "1",
             "PYTHONPATH": os.pathsep.join(
                 p for p in (str(REPO), os.environ.get("PYTHONPATH", "")) if p)}


def make_dataset(root: str, files_per_class: int = 384, classes: int = 2, seed: int = 0,
                 val_files: int = 32) -> str:
    """Synthetic N-ImageNet-shaped data (the reference soak's, draw for
    draw): .npz columns, 30k-120k events a sample on a 640x480 sensor."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", files_per_class), ("val", val_files)):
        for c in range(classes):
            d = os.path.join(root, split, f"cls{c}")
            if os.path.isdir(d):
                continue
            os.makedirs(d)
            for i in range(n):
                m = int(rng.integers(30000, 120000))
                x_lo, x_hi = (0, 400) if c == 0 else (240, 640)
                rec = {
                    "x": rng.integers(x_lo, x_hi, m).astype("<u2"),
                    "y": rng.integers(0, 480, m).astype("<u2"),
                    "t": np.sort(rng.integers(0, 10**6, m)).astype("<i8"),
                    "p": rng.integers(0, 2, m).astype("u1"),
                }
                np.savez(os.path.join(d, f"s{i}.npz"), **rec)
    return root


def _children(pid: int) -> list:
    """The pids whose parent is ``pid``, from ``/proc/*/stat`` (the
    ``task/*/children`` files need a kernel option that hosts may lack)."""
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # "pid (comm) state ppid ...": comm may hold spaces and parentheses
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            out.append(int(name))
    return out


def python_descendant(pid: int):
    """The deepest python descendant of ``pid`` (the trainer under the bash
    wrapper), or None."""
    frontier, last_py = [pid], None
    while frontier:
        nxt = []
        for p in frontier:
            try:
                with open(f"/proc/{p}/comm") as f:
                    if f.read().strip().startswith("python"):
                        last_py = p
            except OSError:
                continue
            nxt += _children(p)
        frontier = nxt
    return last_py


def rss_gb_of(pid) -> float | None:
    """The resident set of ``pid`` in GB (``VmRSS``), or None."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024 / 1e9
    except (OSError, TypeError):
        pass
    return None


def build_snapshot() -> list:
    """(name, mtime_ns) of the kernel library, its build log and libmemev."""
    if not BUILD_DIR.is_dir():
        return []
    return sorted((p.name, p.stat().st_mtime_ns) for p in BUILD_DIR.iterdir()
                  if BUILD_FILES.fullmatch(p.name))


def vae_cmd(args, data: str, vae_dir: str) -> list:
    return [sys.executable, "-m", "mem_tpu_torch.cli.train_vae",
            "--data_path", data, "--output_dir", vae_dir,
            "--epochs", "1", "--batch_size", "32",
            "--input_H", "224", "--input_W", "224",
            "--slice_max_evs", str(args.slice_max_evs),
            "--num_workers", "0", "--wandb", "0", "--auto_resume", "0",
            "--save_ckpt_freq", "1", "--disable_eval",
            "--hotpixfilter", "1", "--rand_aug", "1"]


def train_cmd(args, data: str, out_dir: str, vae_ckpt: str, rss_gb: float = 0.0) -> list:
    trainer = ([sys.executable, "-m", "mem_tpu_torch.tools.resume", args.record,
                "run_mem_pretraining"] if args.record
               else [sys.executable, "-m", "mem_tpu_torch.cli.run_mem_pretraining"])
    return [
        "bash", str(REPO / "scripts" / "run_resilient.sh"), *trainer,
        "--data_path", data, "--output_dir", out_dir,
        "--discrete_vae_weight_path", vae_ckpt,
        "--epochs", "4000", "--batch_size", "128",
        "--input_H", "224", "--input_W", "224",
        "--slice_max_evs", str(args.slice_max_evs),
        "--num_mask_patches", "98",
        "--lr", "5e-4", "--warmup_epochs", "1",
        "--save_ckpt_freq", "20", "--auto_resume", "1",
        "--num_workers", "0", "--wandb", "0",
        "--rss_restart_gb", str(rss_gb),
        "--hotpixfilter", "1", "--rand_aug", "1", "--color_jitter", "0.2",
        "--rand_aug_batch_ops", "1",
        "--disable_eval_during_pretraining",
    ]


# the lines the soak reads (the port's CLIs and run_resilient.sh print them)
EPOCH_LINE = re.compile(r"^epoch (\d+): ([\d.]+) samples/sec")
LOSS_LINE = re.compile(r"^Epoch: \[\d+\] \[\d+/\d+\] loss: ([\d.eE+-]+)")
RESUME_LINE = re.compile(r"^Auto-resumed from (\S+) \(epoch (\d+)\)")
PREEMPT_LINE = re.compile(r"^preempted at epoch (\d+)")
RECYCLE_LINE = re.compile(r"recycling process \(exit 3\)")
RELAUNCH_MARK = "memory recycle"
SETTLE_S = 2.0   # seconds a new trainer runs before it may be signalled


class Segment:
    """One wrapper process: its output, stamped and copied to the log, the
    trainer's resident set at each epoch line, and the SIGTERMs sent."""

    def __init__(self, cmd: list, label: str, log_f):
        self.label, self.lines, self.log_f = label, [], log_f
        self.rss = {}       # index of an epoch line -> GB
        self.exiting = set()  # trainer pids that announced their recycle
        self.seen = {}        # trainer pid -> when the soak first saw it
        log_f.write(f"\n===== SOAK SEGMENT {label} =====\n")
        log_f.flush()
        self.t0 = time.time()
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     cwd=str(REPO), env=CHILD_ENV, text=True, bufsize=1,
                                     errors="replace")
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        for line in self.proc.stdout:
            if EPOCH_LINE.match(line):
                self.rss[len(self.lines)] = rss_gb_of(python_descendant(self.proc.pid))
            elif RECYCLE_LINE.search(line):
                self.exiting.add(python_descendant(self.proc.pid))
            self.lines.append((time.time(), line))
            self.log_f.write(line)
            self.log_f.flush()

    def ready(self, py, need_recycle: bool) -> bool:
        """``py`` has run for :data:`SETTLE_S` and has not announced a
        recycle, and for segment B a recycle has happened. A trainer just
        started may not have installed its early latch yet, and one exiting
        for its recycle has no handler left: Python's teardown resets the
        handlers, so a SIGTERM there ends the wrapper with 143. Setup itself
        is fair game: the CLIs latch the signal before they import torch."""
        if py is None or py in self.exiting:
            return False
        first = self.seen.setdefault(py, time.time())
        recycled = any(RELAUNCH_MARK in ln for _, ln in self.lines)
        return time.time() - first >= SETTLE_S and (recycled or not need_recycle)

    def preempt(self, seconds: float, need_recycle: bool = False, cap: float = 900.0):
        """Wait out ``seconds`` (longer while not :meth:`ready`, up to
        ``cap`` more), then SIGTERM the trainer; again if a recycle beat the
        signal to it. Returns (wrapper exit code, [(pid, t_signal)], t_exit)."""
        deadline = self.t0 + seconds
        sent = []
        while self.proc.poll() is None:
            now = time.time()
            py = python_descendant(self.proc.pid) if now >= deadline else None
            due = py is not None and py not in {p for p, _ in sent} and (
                self.ready(py, need_recycle) or now >= deadline + cap)
            if not due:
                time.sleep(0.5)
                continue
            print(f"[soak] {self.label}: SIGTERM -> pid {py}", flush=True)
            sent.append((py, time.time()))
            os.kill(py, signal.SIGTERM)
        rc = self.proc.wait(timeout=1800)
        t_exit = time.time()
        self.reader.join(timeout=60)
        return rc, sent, t_exit


def parse(segments) -> dict:
    """Per-epoch samples/s and RSS, the loss series, the events and the
    launch-to-resume / launch-to-first-step seconds, over all segments."""
    epochs, loss, events, to_resume, to_step = [], [], [], [], []
    for seg in segments:
        launch, resumed, stepped = seg.t0, False, False
        for i, (t, line) in enumerate(seg.lines):
            if RELAUNCH_MARK in line:
                events.append(("recycle", seg.label, None, len(loss)))
                launch, resumed, stepped = t, False, False
            m = RESUME_LINE.match(line)
            if m:
                events.append(("resume", seg.label, int(m.group(2)), len(loss)))
                if not resumed:
                    to_resume.append(t - launch)
                    resumed = True
            m = LOSS_LINE.match(line)
            if m:
                loss.append(float(m.group(1)))
                if not stepped:
                    to_step.append(t - launch)
                    stepped = True
            m = EPOCH_LINE.match(line)
            if m:
                epochs.append((seg.label, int(m.group(1)), float(m.group(2)), seg.rss.get(i)))
            m = PREEMPT_LINE.match(line)
            if m:
                events.append(("preempt", seg.label, int(m.group(1)), len(loss)))
    return {"epochs": epochs, "losses": loss, "events": events,
            "launch_to_resume_s": to_resume, "launch_to_first_logged_step_s": to_step}


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--minutes", type=float, default=90)
    ap.add_argument("--slice_max_evs", type=int, default=15000)
    ap.add_argument("--workdir", type=str, default="soak_work")
    ap.add_argument("--out", type=str, default=None,
                    help="the markdown report (default <workdir>/SOAK.md)")
    ap.add_argument("--files_per_class", type=int, default=384,
                    help="training files a class (the reference's 384; a cut for short runs)")
    ap.add_argument("--record", type=str, default="",
                    help="a JSONL file: run each trainer through tools/resume.py, which "
                         "appends its steps and kernel launch counts there")
    args = ap.parse_args(argv)

    workdir = os.path.abspath(args.workdir)
    os.makedirs(workdir, exist_ok=True)
    if args.record:
        args.record = os.path.abspath(args.record)
    out_md = args.out or os.path.join(workdir, "SOAK.md")
    t_start = time.time()
    data = make_dataset(os.path.join(workdir, "nimagenet_synth"), args.files_per_class)
    t_data = time.time()
    out_dir = os.path.join(workdir, "pt_out")
    vae_dir = os.path.join(workdir, "vae_out")
    log_path = os.path.join(workdir, "soak.log")
    log_f = open(log_path, "a")

    vae_ckpt = os.path.join(vae_dir, "checkpoint-final.pth")
    if not os.path.exists(vae_ckpt):
        print("[soak] training the stage-1 VAE (1 epoch)...", flush=True)
        rc = subprocess.run(vae_cmd(args, data, vae_dir), stdout=log_f,
                            stderr=subprocess.STDOUT, cwd=str(REPO), env=CHILD_ENV).returncode
        if rc != 0:
            raise SystemExit(f"VAE warm-up failed rc={rc} (see {log_path})")
    t_vae = time.time()

    total = args.minutes * 60
    shares = (("A", 0.45 * total, 0.0), ("B-rss-recycle", 0.2 * total, 1.0),
              ("C", 0.35 * total, 0.0))
    snaps, segments, preempts = [build_snapshot()], [], []
    for label, seconds, rss in shares:
        seg = Segment(train_cmd(args, data, out_dir, vae_ckpt, rss), label, log_f)
        rc, sent, t_exit = seg.preempt(seconds, need_recycle=rss > 0)
        segments.append(seg)
        tagged = [int(m.group(1)) for m in (PREEMPT_LINE.match(ln) for _, ln in seg.lines) if m]
        preempts.append({
            "segment": label, "rc": rc, "signals": len(sent),
            "sigterm_to_exit_s": t_exit - sent[-1][1] if sent else None,
            "epochs": tagged,
            "checkpoints": all(os.path.exists(os.path.join(out_dir, f"checkpoint-{e}.pth"))
                               for e in tagged) and bool(tagged),
            "checkpoint_gb": sum(os.path.getsize(os.path.join(out_dir, n))
                                 for n in os.listdir(out_dir)) / 1e9})
        snaps.append(build_snapshot())
        if label != "C":
            prune_checkpoints(out_dir)   # stage-boundary disk hygiene (no writer now)
    log_f.close()

    p = parse(segments)
    events = p["events"]
    count = {k: sum(1 for e in events if e[0] == k) for k in ("resume", "recycle", "preempt")}
    cont = loss_continuity(p["losses"], [e[3] for e in events if e[0] == "resume"])
    gates = {
        "preemptions_exit_0_with_checkpoint": count["preempt"] >= 2 and all(
            s["rc"] == 0 and s["checkpoints"] for s in preempts),
        "recycles": count["recycle"] >= 1,
        "auto_resumes": count["resume"] >= 3,
        "loss_continuity": cont["ok"],
        "no_kernel_rebuilt_after_segment_A": snaps[1] == snaps[2] == snaps[3],
    }
    sps = [e[2] for e in p["epochs"]]
    rss = [e[3] for e in p["epochs"] if e[3] is not None]
    result = {
        "card": card(), "minutes": args.minutes, "files_per_class": args.files_per_class,
        "slice_max_evs": args.slice_max_evs,
        "setup_s": {"dataset": t_data - t_start, "vae_warmup": t_vae - t_data},
        "epochs_completed": len(p["epochs"]),
        "sigterm_preemptions": count["preempt"], "rss_recycles": count["recycle"],
        "auto_resumes": count["resume"], "segments": preempts,
        "build_files": {"before_A": snaps[0], "after_A": snaps[1], "after_B": snaps[2],
                        "after_C": snaps[3]},
        "loss_points": len(p["losses"]), **{k: v for k, v in cont.items() if k != "ok"},
        "loss_first": p["losses"][0] if p["losses"] else None,
        "loss_last": p["losses"][-1] if p["losses"] else None,
        "samples_per_s": {"median": float(np.median(sps)) if sps else None,
                          "min": min(sps, default=None), "max": max(sps, default=None)},
        "rss_gb": {"min": min(rss, default=None), "max": max(rss, default=None)},
        "sigterm_to_exit_s": [s["sigterm_to_exit_s"] for s in preempts],
        "launch_to_resume_s": p["launch_to_resume_s"],
        "launch_to_first_logged_step_s": p["launch_to_first_logged_step_s"],
        "events": [e[:3] for e in events],
        "epoch_sps_rss": p["epochs"], "gates": gates, "ok": all(gates.values()),
        "seconds": time.time() - t_start,
    }
    with open(os.path.join(workdir, "soak.json"), "w") as f:
        json.dump(result, f, indent=1)
    write_report(out_md, result)
    print(json.dumps({k: v for k, v in result.items()
                      if k not in ("epoch_sps_rss", "events", "build_files")}, indent=1))
    return result


def write_report(path: str, r: dict) -> None:
    rows = "\n".join(f"| {s} | {e} | {rate:.1f} | "
                     f"{'not read' if gb is None else f'{gb:.2f}'} |"
                     for s, e, rate, gb in r["epoch_sps_rss"])
    g = r["gates"]

    def ok(k):
        return "PASS" if g[k] else "FAIL"

    text = f"""# Preemption / endurance soak of the port

`python -m mem_tpu_torch.tools.soak --minutes {r['minutes']:g}`: a synthetic
N-ImageNet-shaped ViT-B MEM pretraining ({r['files_per_class']} training files
a class, B=128, 224^2) under `scripts/run_resilient.sh` on {r['card']}, with
{r['sigterm_preemptions']} SIGTERM preemptions and {r['rss_recycles']} RSS
recycles.

| check | result |
|---|---|
| epochs completed across all restarts | {r['epochs_completed']} |
| graceful SIGTERM preemptions (exit 0 + checkpoint) | {r['sigterm_preemptions']} -> {ok('preemptions_exit_0_with_checkpoint')} |
| RSS recycles (exit 3 -> relaunch) | {r['rss_recycles']} -> {ok('recycles')} |
| auto-resumes | {r['auto_resumes']} -> {ok('auto_resumes')} |
| loss continuity: max jump across a resume vs max adjacent step | {r['max_resume_loss_jump']:.4f} vs {r['max_within_segment_loss_step']:.4f} -> {ok('loss_continuity')} |
| largest adjacent step between resumes | {r['max_step_between_resumes']:.4f} |
| kernel files rebuilt after segment A | {'none' if g['no_kernel_rebuilt_after_segment_A'] else 'some'} -> {ok('no_kernel_rebuilt_after_segment_A')} |
| SIGTERM -> exit, s | {', '.join(f'{s:.2f}' for s in r['sigterm_to_exit_s'] if s is not None)} |
| launch -> resume line, s | {', '.join(f'{s:.2f}' for s in r['launch_to_resume_s'])} |
| launch -> first logged step, s | {', '.join(f'{s:.2f}' for s in r['launch_to_first_logged_step_s'])} |
| samples/s per epoch, median (min-max) | {r['samples_per_s']['median']} ({r['samples_per_s']['min']}-{r['samples_per_s']['max']}) |

Per epoch across restarts:

| segment | epoch | samples/s | trainer RSS, GB |
|---|---|---|---|
{rows}

Event order: {" -> ".join(e[0] for e in r['events'])}.
"""
    with open(path, "w") as f:
        f.write(text)


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
