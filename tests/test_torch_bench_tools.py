"""The port's host benches and load generator (mem_tpu_torch/tools/
bench_host_loader.py, bench_host_feed.py, bench_serve.py) against the
reference's scripts: the synthetic dataset bit-equal to
scripts/bench_host_loader.py's, the loader rates finite and positive at a
small batch, both load generators (scripts/bench_serve.py runs without jax)
against one CPU server of the port, and bench_host_feed's duty-cycle
arithmetic equal to the reference's ``report``."""
import importlib
import io
import json
import os
import re
import sys
import threading
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from mem_tpu_torch.tools import bench_host_feed, bench_host_loader, bench_serve


def _reference(name):
    """scripts/<name>.py, imported on this checkout's sys.path (it prepends
    a fixed path, taken back after)."""
    path = list(sys.path)
    try:
        return importlib.import_module(f"scripts.{name}")
    finally:
        sys.path[:] = path


def test_make_dataset_bit_equal_to_reference(tmp_path):
    ref = _reference("bench_host_loader")
    ref.make_dataset(str(tmp_path / "ref"), n_files=3, n_events=400)
    bench_host_loader.make_dataset(str(tmp_path / "port"), n_files=3, n_events=400)
    names = sorted(os.listdir(tmp_path / "ref" / "train" / "cls"))
    assert names == sorted(os.listdir(tmp_path / "port" / "train" / "cls")) and len(names) == 3
    for n in names:
        a = np.load(tmp_path / "ref" / "train" / "cls" / n)
        b = np.load(tmp_path / "port" / "train" / "cls" / n)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def small_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("loaderbench"))
    bench_host_loader.make_dataset(root, n_files=8, n_events=2000)
    return root


def test_components_finite_positive(small_set):
    parts = bench_host_loader.components(small_set, B=4)
    assert len(parts) == 3 and all(np.isfinite(p) and p > 0 for p in parts)


@pytest.mark.parametrize("native,workers,pool", [(True, 0, 4096), (False, 2, 0)])
def test_bench_rate_finite_positive(small_set, native, workers, pool):
    r = bench_host_loader.bench(small_set, B=4, workers=workers, native=native,
                                mask_pool=pool, nbatches=2)
    assert np.isfinite(r) and r > 0


_FLAGS = ["--nb_classes", "4", "--dataset", "ncaltech101", "--model", "ft_vit",
          "--transformer_emb", "32", "--transformer_depth", "1", "--transformer_heads", "2",
          "--num_layers", "4", "--input_H", "32", "--input_W", "32", "--slice_max_evs", "300",
          "--rand_aug", "0", "--dtype", "float32", "--batch_size", "4", "--max_wait_ms", "5",
          "--topk", "3", "--port", "0", "--device", "cpu"]


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """One CPU server of the port on a tiny seeded ft_vit."""
    from mem_tpu_torch.cli.common import build_classifier
    from mem_tpu_torch.cli.serve import build_server, get_args

    out = tmp_path_factory.mktemp("bench_serve")
    args = get_args(["--checkpoint", str(out)] + _FLAGS)
    model = build_classifier(args, 4, torch.float32, torch.device("cpu"))
    model.init_weights(torch.Generator().manual_seed(0))
    torch.save({"model": model.state_dict(), "epoch": 0}, out / "checkpoint-0.pth")
    httpd, state, threads = build_server(args)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    with state.cv:
        state.stop = True
        state.cv.notify_all()
    httpd.shutdown()
    httpd.server_close()
    for th in threads:
        th.join(timeout=10)


@pytest.mark.parametrize("which", ["reference", "port"])
def test_load_generators_against_the_port_server(server, monkeypatch, which):
    argv = [f"url={server}", "conc=2", "secs=1", "n_events=300", "h=40", "w=50"]
    buf = io.StringIO()
    with redirect_stdout(buf):
        if which == "reference":
            ref = _reference("bench_serve")
            monkeypatch.setattr(sys, "argv", ["bench_serve"] + argv)
            ref.main()
        else:
            bench_serve.main(argv)
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert set(out) == {"requests", "errors", "wall_s", "throughput_rps", "p50_ms", "p95_ms",
                        "p99_ms", "concurrency", "stats"}
    assert out["errors"] == 0 and out["requests"] >= 1 and out["concurrency"] == 2


def test_bench_serve_imports_no_torch():
    import subprocess

    code = ("import sys, mem_tpu_torch.tools.bench_serve; "
            "assert 'torch' not in sys.modules and 'jax' not in sys.modules")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=repo), timeout=120)
    assert r.returncode == 0, r.stderr


_LINE = re.compile(r"wire +([\d.]+) ms/batch \| pipelined +(\d+) samples/s \((\w+)-bound\) \| "
                   r"duty +([\d.]+)% of step")


@pytest.mark.parametrize("loader_sps,nbytes,step_ms,B", [
    (900.0, 23_000_000, 160.4, 128),     # device-bound on the fast wires
    (40.0, 23_000_000, 160.4, 128),      # loader-bound
    (5000.0, 180_000_000, 50.0, 16)])    # wire-bound on the slow wire
def test_report_arithmetic_equals_reference(monkeypatch, loader_sps, nbytes, step_ms, B):
    """The same loader rate, bytes, step, staging rate and copy rates through
    the reference's ``report`` (its three wires' constants set to the copy
    rates here) and the port's: every printed number and bound equal."""
    ref = _reference("bench_host_feed")
    rates = (41e6, 12e9, 25e9)
    monkeypatch.setattr(ref, "TUNNEL_MBS", rates[0] / 1e6)
    monkeypatch.setattr(ref, "PCIE_GBS", rates[1] / 1e9)
    monkeypatch.setattr(ref, "DCN_GBS", rates[2] / 1e9)
    stage_bps = 3.5e9
    monkeypatch.setattr(ref.report, "stage_bps", stage_bps, raising=False)
    buf = io.StringIO()
    with redirect_stdout(buf):
        ref.report("t", loader_sps, nbytes, step_ms, B)
    want = [m.groups() for m in map(_LINE.search, buf.getvalue().splitlines()) if m]
    buf = io.StringIO()
    with redirect_stdout(buf):
        rows = bench_host_feed.report("t", loader_sps, nbytes, step_ms, B,
                                      [(f"w{i}", r, stage_bps) for i, r in enumerate(rates)])
    got = [m.groups() for m in map(_LINE.search, buf.getvalue().splitlines()) if m]
    assert len(want) == 3 and got == want
    for row, r in zip(rows, rates):
        stage_s, wire_s = nbytes / stage_bps, nbytes / r
        total = max(B / loader_sps, stage_s + wire_s, step_ms / 1e3)
        assert row["pipelined_samples_per_s"] == B / total
        assert row["duty"] == (stage_s + wire_s) / (step_ms / 1e3)


def test_report_without_a_step_or_staging():
    rows = bench_host_feed.report("t", 100.0, 1e6, None, 8, [("pageable", 1e9, None)],
                                  quiet=True)
    assert rows[0]["bound"] == "loader" and rows[0]["duty"] is None
    assert rows[0]["stage_ms"] == 0.0 and rows[0]["wire_ms"] == 1.0


def test_bench_host_loader_main_small(capsys):
    """The whole sweep at one batch of 8 a setting over 24 files, a mask
    pool of 64: 16 rates."""
    assert bench_host_loader.main(["files=24", "nbatches=1", "B=8", "pool=64"]) == 0
    rates = re.findall(r": (\d+) samples/s", capsys.readouterr().out)
    assert len(rates) == 16 and all(int(r) > 0 for r in rates)


def test_bench_host_feed_cpu_loaders(tmp_path, capsys):
    """device=cpu: the loaders alone, every row with a positive rate and no
    copy path."""
    assert bench_host_feed.main(["device=cpu", "B=8", "seg_B=2", "nbatches=1", "files=16",
                                 "ni_files=16", "dsec_files=4", f"dir={tmp_path}"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(out["rows"]) == 4 and "staging" not in out
    assert all(r["loader_samples_per_s"] > 0 and r["paths"] == [] for r in out["rows"])
