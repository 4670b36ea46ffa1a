"""The finetune eval under two processes on a val split that does not divide
(ROADMAP queue 3, suspect S4), on the CPU.

13 val recordings over 2 processes at a per-process batch of 2: the shards
are ``idx[r::2]`` (7 and 6 recordings, 4 and 3 batches, the last one
wrap-padded). The port's eval loops run the batches every process has
(``parallel/mesh.py`` ``common_count``), so each counts 3 batches of 2, 12
samples in all, and the 13th recording is not evaluated; one process counts
16 (13 and the last batch's 3 wrap-padded repeats), as the JAX package does
in one process. The JAX package's finetune CLI does not start under two
processes at all: ``mem_tpu/ops/image_ops.py:167`` builds a ``jnp`` array at
import, which starts the XLA backend, so ``jax.distributed.initialize()`` in
``init_distributed`` raises. Its sample count and top-1 there cannot be
compared; these tests pin both behaviours.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from mem_tpu_torch.tools.mp_worker import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# runs a CLI module as __main__ and prints the samples each eval update counted
_COUNTED = """
import atexit, importlib, runpy, sys
module = sys.argv[1]
sys.argv = [module] + sys.argv[2:]
M = importlib.import_module(module.split(".")[0] + ".utils.metrics")
real, seen = M.MetricLogger.update, []
def update(self, **kw):
    seen.append(kw.get("n"))
    return real(self, **kw)
M.MetricLogger.update = update
atexit.register(lambda: print("COUNTED", seen, flush=True))
runpy.run_module(module, run_name="__main__")
"""


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from mem_tpu_torch.models.registry import create_model

    tmp = tmp_path_factory.mktemp("eval_split")
    rng = np.random.default_rng(0)
    root = tmp / "data"
    for split, n in (("train", 8), ("val", 13)):
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
    torch.save({"model": pt.state_dict(), "epoch": 0}, tmp / "pt.pth")
    flags = ["--data_path", str(root), "--finetune", str(tmp / "pt.pth"), "--nb_classes", "2",
             "--input_H", "32", "--input_W", "32", "--num_layers", "2",
             "--transformer_emb", "32", "--transformer_depth", "2", "--transformer_heads", "4",
             "--batch_size", "4", "--slice_max_evs", "1500", "--max_random_shift_evs", "2",
             "--num_workers", "0", "--dtype", "float32", "--eval", "--auto_resume", "0",
             "--init_scale", "1.0"]
    return tmp, flags


def _run(module, flags, envs, timeout=300):
    """One process per env; returns [(exit code, output)] by rank."""
    procs = [subprocess.Popen([sys.executable, "-c", _COUNTED, module, *flags], env=env,
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for env in envs]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            outs.append("timed out\n" + p.communicate()[0])
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def _counted(out):
    m = re.search(r"^COUNTED (\[.*\])$", out, re.M)
    assert m, out[-2000:]
    return eval(m.group(1))


def test_port_eval_counts_the_batches_every_process_has(inputs):
    """Two processes (Gloo): 3 batches of 2 each, 12 of the 13 samples, one
    top-1 on both ranks; one process: 4 batches of 4, 13 samples and the
    last batch's 3 wrap-padded repeats."""
    tmp, flags = inputs
    base = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    port = free_port()
    two = [dict(base, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                RANK=str(r), LOCAL_RANK=str(r)) for r in range(2)]
    module = "mem_tpu_torch.cli.run_class_finetuning"
    ranks = _run(module, flags + ["--device", "cpu", "--output_dir", str(tmp / "two")], two)
    assert all(rc == 0 for rc, _ in ranks), [o[-2000:] for _, o in ranks]
    assert [_counted(o) for _, o in ranks] == [[2, 2, 2], [2, 2, 2]]
    acc = [re.search(r"^\* eval acc1 ([0-9.]+)", o, re.M).group(1) for _, o in ranks]
    assert acc[0] == acc[1]
    hits = float(acc[0]) * 12 / 100          # a share of 12 samples, printed to 0.01
    assert abs(hits - round(hits)) < 0.01, acc
    (rc, out), = _run(module, flags + ["--device", "cpu", "--output_dir", str(tmp / "one")],
                      [base])
    assert rc == 0, out[-2000:]
    assert _counted(out) == [4, 4, 4, 4]


def test_jax_finetune_eval_does_not_start_under_two_processes(inputs):
    """The JAX package's CLI under two processes (jax.distributed's SLURM
    variables, a localhost coordinator): both exit at initialisation."""
    tmp, flags = inputs
    port = free_port()
    envs = [dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=1", JAX_PROCESS_COUNT="2",
                 SLURM_JOB_ID="1", SLURM_STEP_NODELIST="localhost", SLURM_NTASKS="2",
                 SLURM_PROCID=str(r), SLURM_LOCALID=str(r), SLURM_STEP_NUM_NODES="1",
                 JAX_COORDINATOR_PORT=str(port)) for r in range(2)]
    ranks = _run("mem_tpu.cli.run_class_finetuning", flags + ["--output_dir", str(tmp / "jax")],
                 envs, timeout=240)
    for rc, out in ranks:
        assert rc != 0 and "jax.distributed.initialize() must be called before" in out, \
            out[-2000:]
        assert _counted(out) == []
