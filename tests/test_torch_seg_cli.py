"""The port's segmentation entry points on ``--device cpu``: ``test_seg`` end to
end against ``mem_tpu.cli.test_seg`` on the same converted checkpoint (the
summary line within 1e-3, single-scale and with test-time augmentation), the
seg server's PNG round trip, and the import rule of the port (nothing of jax
or of the JAX package)."""
import functools
import io
import os
import re
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mem_tpu.cli.test_seg import main as jax_test_seg
from mem_tpu.models.segmentation import EncoderDecoder as JaxEncoderDecoder
from mem_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from mem_tpu_torch.cli import serve
from mem_tpu_torch.cli import test_seg as cli
from mem_tpu_torch.data.seg_pipeline import seg_preprocess_batch
from mem_tpu_torch.models.segmentation import build_segmentor
from mem_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from mem_tpu_torch.utils.weights import seg_from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_CLASSES = 3
_SIZE = ["--seg_input_size", "64", "--embed_dim", "32", "--depth", "2", "--num_heads", "2"]
MIOU_TOL = 1e-3      # of the printed fractions: near-tie argmax flips at a few pixels


@pytest.fixture(scope="module")
def synth_seg_dataset(tmp_path_factory):
    """The recipe of tests/test_segmentation.py's fixture of the same name,
    with 20,000-30,000 events a recording: with a few thousand the hot-pixel
    threshold (mean + 10 std of the counts) falls below one count, every
    image is zeros and every prediction one class."""
    from PIL import Image

    root = tmp_path_factory.mktemp("dsec")
    rng = np.random.default_rng(5)
    (root / "imgs" / "val" / "seq0").mkdir(parents=True)
    (root / "anns" / "val" / "seq0").mkdir(parents=True)
    for i in range(3):
        ne = int(rng.integers(20000, 30000))
        ev = np.zeros((ne, 4), np.float32)
        ev[:, 0] = rng.integers(0, 640, ne)
        ev[:, 1] = rng.integers(0, 480, ne)   # includes y >= 440, to be cropped
        ev[: ne // 2, 0] = np.clip(rng.normal(200 + 100 * i, 60, ne // 2), 0, 639).astype(int)
        ev[:, 3] = rng.integers(0, 2, ne)
        np.save(root / "imgs" / "val" / "seq0" / f"{i:06d}.npy", ev)
        lab = rng.integers(0, NUM_CLASSES, (440, 640)).astype(np.uint8)
        lab[:10] = 255  # ignore band
        Image.fromarray(lab).save(root / "anns" / "val" / "seq0" / f"{i:06d}.png")
    return str(root)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One segmentor, weights redrawn from numpy, saved as the JAX
    package's checkpoint and, converted, as the port's .pth."""
    root = tmp_path_factory.mktemp("ckpt")
    rng = np.random.default_rng(11)
    model = JaxEncoderDecoder(
        num_classes=NUM_CLASSES,
        backbone_cfg=dict(img_size=64, embed_dim=32, depth=2, num_heads=2,
                          out_indices=(0, 0, 0, 1)),
        dtype=jnp.float32)
    variables = jax.jit(functools.partial(model.init, train=False))(
        jax.random.key(0), jnp.zeros((1, 88, 128, 3), jnp.float32))

    def redraw(path, leaf):
        """Products keep flax's fan-in scaled init; every bias, table,
        LayerScale, BatchNorm scale and running statistic is redrawn."""
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            return np.asarray(leaf)
        if "'var'" in name:
            return np.asarray(0.5 + rng.random(leaf.shape), np.float32)
        base = 1.0 if "scale" in name else 0.0
        return np.asarray(base + 0.2 * rng.standard_normal(leaf.shape), np.float32)

    variables = jax.tree_util.tree_map_with_path(redraw, jax.device_get(variables))
    jax_save_checkpoint(str(root / "jax"), "final", {
        "params": variables["params"], "batch_stats": variables["batch_stats"]})
    pth = save_checkpoint(str(root / "torch"), "final",
                          {"model": seg_from_jax_params(variables), "epoch": 0})
    return os.path.join(str(root / "jax"), "checkpoint-final"), pth


def _summary(text):
    line = [ln for ln in text.splitlines() if ln.startswith("mIoU")][-1]
    return {k: float(v) / 100 for k, v in re.findall(r"(\w+) ([0-9.]+|nan)", line)}


@pytest.mark.parametrize("tta", [[], ["--aug_test", "1", "--aug_scales", "1.0,0.5"]],
                         ids=["single_scale", "aug_test"])
def test_test_seg_matches_jax_cli(synth_seg_dataset, checkpoints, capsys, tmp_path, tta):
    jax_ckpt, pth = checkpoints
    flags = ["--data_root", synth_seg_dataset, "--num_classes", str(NUM_CLASSES), *_SIZE,
             "--batch_size", "8", "--slice_max_evs", "25000", "--dtype", "float32", *tta]
    jax_test_seg(flags + ["--checkpoint", jax_ckpt])
    want = _summary(capsys.readouterr().out)
    save_dir = str(tmp_path / "preds")
    stats = cli.main(flags + ["--checkpoint", pth, "--device", "cpu", "--save_dir", save_dir])
    out = capsys.readouterr().out
    got = _summary(out)
    assert set(got) == {"mIoU", "mDice", "mFscore", "aAcc"} == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= MIOU_TOL, (k, got, want)
    assert abs(stats["mIoU"] - got["mIoU"]) < 1e-4
    assert len([ln for ln in out.splitlines() if re.match(r"^\d+ ", ln)]) == NUM_CLASSES
    # one PNG per real sample (the padded duplicates are dropped), labels in range
    from PIL import Image

    files = sorted(os.listdir(save_dir))
    assert files == ["000000.png", "000001.png", "000002.png"]
    pred = np.asarray(Image.open(os.path.join(save_dir, files[0])))
    assert pred.shape == (440, 640) and pred.max() < NUM_CLASSES
    assert np.bincount(pred.ravel()).max() < 0.98 * pred.size    # not one class


def test_test_seg_int8_matches_jax_cli(synth_seg_dataset, checkpoints, capsys, monkeypatch):
    """``test_seg --int8 1`` against ``mem_tpu.cli.test_seg --int8 1`` (which
    sets its module flag for the process: restored here after the test):
    the summary line within MIOU_TOL; the port's flag is restored after the
    run and the run differs from the f32 one only by int8 noise."""
    from mem_tpu.models import vit as jax_vit
    from mem_tpu_torch.models import vit

    monkeypatch.setattr(jax_vit, "INT8_GEMM", False)
    jax_ckpt, pth = checkpoints
    flags = ["--data_root", synth_seg_dataset, "--num_classes", str(NUM_CLASSES), *_SIZE,
             "--batch_size", "8", "--slice_max_evs", "25000", "--dtype", "float32",
             "--int8", "1"]
    jax_test_seg(flags + ["--checkpoint", jax_ckpt])
    assert jax_vit.INT8_GEMM is True
    want = _summary(capsys.readouterr().out)
    stats = cli.main(flags + ["--checkpoint", pth, "--device", "cpu"])
    got = _summary(capsys.readouterr().out)
    assert vit.INT8_GEMM is False
    for k in want:
        assert abs(got[k] - want[k]) <= MIOU_TOL, (k, got, want)
    assert abs(stats["mIoU"] - got["mIoU"]) < 1e-4


def test_test_seg_refusals(synth_seg_dataset, checkpoints, monkeypatch):
    _, pth = checkpoints
    flags = ["--data_root", synth_seg_dataset, "--checkpoint", pth,
             "--num_classes", str(NUM_CLASSES), *_SIZE]
    assert cli.get_args(flags).device == "cuda"          # the card is the default
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(flags)


def test_seg_checkpoint_roundtrip(checkpoints):
    """utils.checkpoint saves and loads the seg .pth; the segmentor takes
    it strictly, running statistics included."""
    _, pth = checkpoints
    payload = load_checkpoint(pth)
    model = build_segmentor(NUM_CLASSES, 64, 32, 2, 2, torch.float32, "cpu")
    model.load_state_dict(payload["model"], strict=True)
    assert "backbone.fpn1_bn.running_var" in payload["model"]
    assert "decode_head.psp_bottleneck.bn.running_mean" in payload["model"]


def test_seg_surface_png_roundtrip(checkpoints, rng):
    """--surface seg: a DSEC-format event window in, a 440x640 PNG label map
    out, equal to the direct forward's argmax (as tests/test_serve.py's seg
    test, plus the equality)."""
    from PIL import Image

    _, pth = checkpoints
    args = serve.get_args([
        "--checkpoint", pth, "--surface", "seg", "--num_classes", str(NUM_CLASSES),
        "--transformer_emb", "32", "--transformer_depth", "2", "--transformer_heads", "2",
        "--seg_input_size", "64", "--slice_max_evs", "25000", "--batch_size", "2",
        "--max_wait_ms", "20", "--dtype", "float32", "--port", "0", "--device", "cpu"])
    httpd, state, threads = serve.build_server(args)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        n = 30000                              # above the cap: a window is cut
        ev = np.zeros((n, 4), np.float64)
        ev[:, 0] = rng.integers(0, 640, n)
        ev[: n // 2, 0] = np.clip(rng.normal(200, 60, n // 2), 0, 639).astype(int)
        ev[:, 1] = rng.integers(0, 470, n)     # some rows crop at y >= 440
        ev[:, 2] = np.sort(rng.integers(0, 10**6, n))
        ev[:, 3] = rng.integers(0, 2, n)       # on-disk p in {0, 1}
        body = io.BytesIO()
        np.save(body, ev)
        req = urllib.request.Request(url + "/predict", data=body.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200 and r.headers["Content-Type"] == "image/png"
            png = np.asarray(Image.open(io.BytesIO(r.read())))
    finally:
        with state.cv:
            state.stop = True
            state.cv.notify_all()
        httpd.shutdown()
        httpd.server_close()
        for th in threads:
            th.join(timeout=10)
    assert png.shape == (440, 640) and png.dtype == np.uint8 and png.max() < NUM_CLASSES
    assert len(np.unique(png)) > 1

    batch = serve.make_seg_assemble(25000, True)([(ev, False)], 2)
    assert batch["n_valid"].tolist() == [25000, 25000]     # wrap-padded
    ys = batch["events"][0, :, 1]
    assert ys.max() < 440 and bool((np.diff(ys) >= 0).all())
    assert set(np.unique(batch["events"][0, :, 3])) == {-1.0, 1.0}
    model = build_segmentor(NUM_CLASSES, 64, 32, 2, 2, torch.float32, "cpu").eval()
    model.load_state_dict(load_checkpoint(pth)["model"], strict=True)
    with torch.inference_mode():
        images, _ = seg_preprocess_batch({k: torch.from_numpy(v) for k, v in batch.items()},
                                         False, y_sorted=True)
        want = model(images)[0].argmax(dim=-1)[0].numpy()
    np.testing.assert_array_equal(png, want)


def test_seg_assemble_keeps_signed_payloads(rng):
    """A structured payload arrives with p already +-1: no second remap
    (serve.py:415-423 of the reference)."""
    ev = np.zeros((50, 4), np.float64)
    ev[:, 0] = rng.integers(0, 640, 50)
    ev[:, 1] = rng.integers(0, 440, 50)
    ev[:, 3] = rng.choice([-1.0, 1.0], 50)
    batch = serve.make_seg_assemble(100, True)([(ev, True)], 1)
    assert batch["n_valid"].tolist() == [50]
    assert set(np.unique(batch["events"][0, :50, 3])) == {-1.0, 1.0}
    assert float(np.abs(batch["events"][0, 50:]).max()) == 0.0


_IMPORT_ALL = r'''
import importlib, importlib.abc, pkgutil, sys

BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "mem_tpu", "scripts")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError(f"the port must not import {name}")
        return None

sys.meta_path.insert(0, Refuse())
import mem_tpu_torch
names = ["mem_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    mem_tpu_torch.__path__, "mem_tpu_torch.", onerror=lambda n: (_ for _ in ()).throw(
        ImportError(n)))]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not bad, bad
assert len(names) > 38, names
for new in ("ops.mlp", "train.mixup", "cli.run_class_finetuning", "tools.exp_voxelize",
            "tools.exp_attn_bwd", "tools.exp_voxelize2", "parallel.mesh", "parallel.pipeline",
            "cli.export_torch", "tools.mp_worker", "tools.mp_chip", "tools.trajectory",
            "tools.trajectory_faults", "tools.soak", "tools.resume", "tools.step_timers",
            "tools.trace_pretrain", "tools.trace_finetune", "tools.trace_mae", "tools.trace_vae",
            "tools.trace_seg", "tools.trace_infer", "tools.bench_pretrain_step",
            "tools.bench_serve", "tools.bench_host_loader", "tools.bench_host_feed"):
    assert "mem_tpu_torch." + new in names, new
print("imported", len(names) + 1)
'''


def test_port_imports_nothing_of_jax_or_the_jax_package():
    """Every module of mem_tpu_torch (the measuring tools and their step
    timers among them) and chip_smoke imports with a meta-path finder that
    refuses jax, flax, optax, orbax, mem_tpu and the reference's scripts
    (extends
    test_pretraining_import_loads_no_jax of tests/test_torch_train.py)."""
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "imported" in r.stdout
