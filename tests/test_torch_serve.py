"""The whole serving slice of the port on the CPU: batch assembly and the
served forward (preprocess, ft_vit, softmax, top-k) held against
mem_tpu.cli.serve's cls surface with the same weights, the port's HTTP
server (mirroring tests/test_serve.py), the jax-free import rule and the
device/surface guards."""
import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_MODEL_FLAGS = [
    "--nb_classes", "4", "--dataset", "ncaltech101", "--model", "ft_vit",
    "--transformer_emb", "32", "--transformer_depth", "2",
    "--transformer_heads", "2", "--num_layers", "4",
    "--input_H", "32", "--input_W", "32", "--slice_max_evs", "500",
    "--hotpixfilter", "1", "--rand_aug", "0", "--dtype", "float32",
    "--batch_size", "4", "--max_wait_ms", "100", "--topk", "3", "--port", "0",
]


def _events(rng, n=300):
    ev = np.zeros((n, 4), np.float64)
    ev[:, 0] = rng.integers(0, 200, n)
    ev[:, 1] = rng.integers(0, 150, n)
    ev[:, 2] = np.sort(rng.integers(0, 10**6, n))
    ev[:, 3] = rng.choice([-1.0, 1.0], n)
    return ev


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One flax ft_vit: as an orbax checkpoint for mem_tpu's server and as
    an export_torch-format .pth for the port's."""
    from mem_tpu.cli.run_class_finetuning import _build_ft_vit
    from mem_tpu.cli.serve import get_args
    from mem_tpu.utils.checkpoint import save_checkpoint
    from mem_tpu.utils.torch_import import export_vit_params

    out = tmp_path_factory.mktemp("serve_port")
    jax_dir, pth_dir = out / "orbax", out / "pth"
    pth_dir.mkdir()
    args = get_args(["--checkpoint", str(jax_dir)] + _MODEL_FLAGS)
    model = _build_ft_vit(args, 4, 16, jnp.float32)
    variables = jax.jit(model.init)(jax.random.key(0), jnp.zeros((2, 32, 32, 3)))
    rng = np.random.default_rng(1)
    variables = jax.tree.map(   # non-trivial biases, tables and head
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.standard_normal(a.shape),
                              jnp.float32), variables)
    save_checkpoint(str(jax_dir), 0, {"params": variables, "epoch": 0})
    sd = {k: torch.from_numpy(v.copy()) for k, v in export_vit_params(variables).items()}
    torch.save({"model": sd, "epoch": 0}, pth_dir / "checkpoint-0.pth")
    return str(jax_dir), str(pth_dir)


@pytest.fixture(scope="module")
def surfaces(checkpoints):
    """(assemble, infer, unpack) of mem_tpu's and of the port's cls surface."""
    from mem_tpu.cli import serve as jax_serve
    from mem_tpu_torch.cli import serve

    jax_dir, pth_dir = checkpoints
    jargs = jax_serve.get_args(["--checkpoint", jax_dir] + _MODEL_FLAGS)
    targs = serve.get_args(["--checkpoint", pth_dir, "--device", "cpu"] + _MODEL_FLAGS)
    return (jax_serve._build_cls(jargs, jnp.float32),
            serve._build_cls(targs, torch.float32, torch.device("cpu")))


_REQUESTS = {
    "one_wrap_padded": [300],
    "over_cap_sliced": [800, 120, 650],
    "full_bucket_with_empty": [200, 0, 700, 50],
}


@pytest.mark.parametrize("case", sorted(_REQUESTS))
def test_assemble_identical_to_jax(rng, surfaces, case):
    (jassemble, _, _), (tassemble, _, _) = surfaces
    reqs = [(_events(rng, n), False) for n in _REQUESTS[case]]
    want, got = jassemble(reqs, 4), tassemble(reqs, 4)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("case", sorted(_REQUESTS))
def test_served_forward_matches_jax(rng, surfaces, case):
    """Same batch through both forwards: top-k probabilities at the f32
    tolerance (1e-5; sums run in another order), class indices equal
    wherever neighbouring probabilities are not tied within it."""
    from mem_tpu_torch.cli.serve import fetch

    (jassemble, jinfer, _), (_, tinfer, _) = surfaces
    batch = jassemble([(_events(rng, n), False) for n in _REQUESTS[case]], 4)
    jprobs, jidx = (np.asarray(a) for a in jinfer(batch))
    tprobs, tidx = fetch(tinfer(batch))
    np.testing.assert_allclose(tprobs, jprobs, rtol=0, atol=1e-5)
    untied = np.ones(jprobs.shape, bool)
    gaps = np.abs(np.diff(jprobs, axis=1)) > 1e-4
    untied[:, :-1] &= gaps
    untied[:, 1:] &= gaps
    np.testing.assert_array_equal(tidx[untied], jidx[untied])


@pytest.fixture(scope="module")
def server(checkpoints):
    from mem_tpu_torch.cli.serve import build_server, get_args

    _, pth_dir = checkpoints
    args = get_args(["--checkpoint", pth_dir, "--device", "cpu"] + _MODEL_FLAGS)
    httpd, state, _ = build_server(args)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", state
    with state.cv:
        state.stop = True
        state.cv.notify_all()
    httpd.shutdown()
    httpd.server_close()


def _post_npy(url, arr):
    b = io.BytesIO()
    np.save(b, arr)
    req = urllib.request.Request(url + "/predict", data=b.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read()), r.status


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=10) as r:
        return json.loads(r.read()), r.status


def test_healthz_warm(server):
    url, _ = server
    body, code = _get(url, "/healthz")
    assert code == 200 and body == {"ok": True, "warm": True}


def test_predict_single_wrap_padded(server, rng):
    url, _ = server
    body, code = _post_npy(url, _events(rng))
    assert code == 200
    tk = body["topk"]
    assert len(tk) == 3
    probs = [p for _, p in tk]
    assert probs == sorted(probs, reverse=True)
    assert 0 < sum(probs) <= 1.0 + 1e-6
    assert all(0 <= c < 4 for c, _ in tk)
    assert body["queue_ms"] >= 0


def test_predict_structured_and_deterministic(server, rng):
    """x/y/t/p structured arrays map to the same rows as the (N, 4) float
    payload -> identical top-k."""
    ev = _events(rng, 200)
    arr = np.zeros(200, dtype=[("x", "<u2"), ("y", "<u2"), ("t", "<u4"), ("p", "u1")])
    arr["x"], arr["y"], arr["t"] = ev[:, 0], ev[:, 1], ev[:, 2]
    arr["p"] = (ev[:, 3] > 0).astype(np.uint8)
    url, _ = server
    a, _ = _post_npy(url, ev)
    b, _ = _post_npy(url, arr)
    assert a["topk"] == b["topk"]


def test_concurrent_requests_batch_together(server):
    url, state = server
    before = state.stats()
    results = []

    def go(seed):
        results.append(_post_npy(url, _events(np.random.default_rng(seed))))

    ts = [threading.Thread(target=go, args=(s,)) for s in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert len(results) == 4 and all(code == 200 for _, code in results)
    after = state.stats()
    assert after["served"] - before["served"] == 4
    assert after["batches"] - before["batches"] <= 3   # batching happened


def test_stats_shape(server):
    url, _ = server
    body, code = _get(url, "/stats")
    assert code == 200
    for k in ("queue_depth", "batch_ms_ema", "added_latency_ms", "served",
              "batches", "avg_fill", "batch_size", "warm"):
        assert k in body, k
    assert body["batch_size"] == 4 and body["warm"] is True


def test_bad_payload_is_a_400(server):
    url, _ = server
    req = urllib.request.Request(url + "/predict", data=b"not an npy", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=10)
    assert e.value.code == 400


_NO_JAX = ("bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'orbax')]; "
           "assert not bad, bad")


def _run_py(code):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_import_loads_no_jax():
    r = _run_py("import sys, mem_tpu_torch.cli.serve; " + _NO_JAX)
    assert r.returncode == 0, r.stderr


def test_serving_loads_no_jax(checkpoints):
    """Build the port's server from the .pth and answer one request in a
    fresh interpreter: still no jax, flax or orbax module."""
    _, pth_dir = checkpoints
    flags = ["--checkpoint", pth_dir, "--device", "cpu"] + _MODEL_FLAGS
    code = (
        "import io, json, sys, threading, urllib.request\n"
        "import numpy as np\n"
        "from mem_tpu_torch.cli.serve import build_server, get_args\n"
        f"httpd, state, _ = build_server(get_args({flags!r}))\n"
        "threading.Thread(target=httpd.serve_forever, daemon=True).start()\n"
        "ev = np.zeros((50, 4)); ev[:, :2] = 7; ev[:, 3] = 1\n"
        "b = io.BytesIO(); np.save(b, ev)\n"
        "url = f'http://127.0.0.1:{httpd.server_address[1]}/predict'\n"
        "r = urllib.request.urlopen(urllib.request.Request(url, data=b.getvalue(), method='POST'))\n"
        "assert len(json.loads(r.read())['topk']) == 3\n"
        "httpd.shutdown()\n" + _NO_JAX)
    r = _run_py(code)
    assert r.returncode == 0, r.stderr


def test_device_cuda_without_card_raises(checkpoints):
    from mem_tpu_torch.cli.serve import build_server, get_args

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, pth_dir = checkpoints
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_server(get_args(["--checkpoint", pth_dir, "--device", "cuda"] + _MODEL_FLAGS))


@pytest.mark.parametrize("flags,slice_name", [
    (["--surface", "seg", "--int8", "1"], "quantization"),
    (["--int8", "1"], "quantization"),
])
def test_unported_surfaces_raise(checkpoints, monkeypatch, flags, slice_name):
    """--int8 1 is ported on both surfaces (the quantization slice): the
    server builds, and each forward it runs, the warm-up included, sees
    ``models.vit.INT8_GEMM`` set; the flag is restored around it."""
    from mem_tpu_torch.cli import serve
    from mem_tpu_torch.models import vit

    seen = []

    def build(args, dtype, device):
        def infer(batch):
            seen.append(vit.INT8_GEMM)
            return (torch.zeros(4, 3), torch.zeros(4, 3, dtype=torch.long)), None
        return (lambda reqs, B: {}), infer, (lambda j, out, q: ("application/json", b"{}"))

    monkeypatch.setattr(serve, "_build_seg" if "seg" in flags else "_build_cls", build)
    _, pth_dir = checkpoints
    args = serve.get_args(["--checkpoint", pth_dir, "--device", "cpu"] + _MODEL_FLAGS + flags)
    httpd, state, threads = serve.build_server(args)
    with state.cv:
        state.stop = True
        state.cv.notify_all()
    httpd.server_close()
    for t in threads:
        t.join(timeout=10)
    assert seen == [True] and vit.INT8_GEMM is False and slice_name == "quantization"


def test_checkpoint_dir_takes_newest_pth_and_refuses_orbax(checkpoints, tmp_path):
    from mem_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint

    jax_dir, pth_dir = checkpoints
    assert latest_checkpoint(pth_dir) == os.path.join(pth_dir, "checkpoint-0.pth")
    old, new = tmp_path / "a.pth", tmp_path / "b.pth"
    torch.save({"model": {}, "epoch": 1}, new)
    torch.save({"model": {}, "epoch": 0}, old)
    os.utime(new, (2e9, 2e9))
    assert latest_checkpoint(str(tmp_path)) == str(new)
    assert load_checkpoint(str(new))["epoch"] == 1
    assert latest_checkpoint(jax_dir) is None
    with pytest.raises(ValueError, match="orbax"):
        load_checkpoint(jax_dir)
