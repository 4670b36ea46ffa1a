"""The port's dataset tools held against the JAX package's CLIs on the same
raw files: ``process_dataset`` (N-Caltech101 ATIS .bin with a split file,
N-Cars .dat, N-ImageNet .npz, DSEC events.h5 where h5py is present) at
``--cores`` 1 and 2, and with the numpy decoders that stand in where the
native library does not build, gives a byte-identical .npy tree; ``make_subsets`` writes identical files. Then the
round trip that stands in for ``export_torch``: the port's finetune CLI
trains on the processed tree (``--opt lookahead_adamp --pretrained 1``,
printing ``pretrained = True`` as the reference does), and
``mem_tpu.utils.torch_import.import_vit_state_dict`` loads its checkpoint
and the pretraining CLI's into flax models that give the port's logits."""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mem_tpu.cli import make_subsets as jax_make_subsets
from mem_tpu.cli import process_dataset as jax_process_dataset
from mem_tpu.events.decoders import encode_atis_bytes, encode_ncars_bytes
from mem_tpu.models.registry import create_model as jax_create_model
from mem_tpu.utils.torch_import import import_vit_state_dict
from mem_tpu_torch import native
from mem_tpu_torch.cli import make_subsets, process_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ("accordion", "airplanes", "anchor")


def _events(rng, n, xmax, ymax, pol):
    ev = np.zeros((n, 4))
    ev[:, 0] = rng.integers(0, ymax, n)      # [y, x, t, p]: the datasets' column order
    ev[:, 1] = rng.integers(0, xmax, n)
    ev[:, 2] = np.sort(rng.integers(0, 2**22, n))
    ev[:, 3] = rng.choice(pol, n)
    return ev


def _write_raw(root, dataset, rng):
    """A raw tree in the dataset's layout; returns the CLI's extra flags."""
    if dataset == "ncaltech101":
        lines = []
        for c in CLASSES:
            os.makedirs(root / c)
            for i in range(6):
                stem = f"image_{i:04d}"
                (root / c / f"{stem}.bin").write_bytes(encode_atis_bytes(
                    _events(rng, int(rng.integers(200, 900)), 32, 24, [-1.0, 1.0])))
                if i < 4:
                    lines.append(f"train/{c}/{stem}.npy")
                elif i == 4:
                    lines.append(f"val/{c}/{stem}.npy")   # image_0005 is in neither list
        split = root.parent / "split.txt"
        split.write_text("\n".join(lines) + "\n")
        return ["--split", str(split)]
    if dataset == "ncars":
        for name in ("n-cars_train", "n-cars_test"):
            for c in ("cars", "background"):
                os.makedirs(root / name / c)
                for i in range(3):
                    (root / name / c / f"obj_{i:06d}_td.dat").write_bytes(encode_ncars_bytes(
                        _events(rng, int(rng.integers(100, 500)), 120, 100, [0.0, 1.0])))
        return []
    if dataset == "nimagenet":
        rec = [("x", "<u2"), ("y", "<u2"), ("t", "<i8"), ("p", "u1")]
        for name in ("extracted_train", "extracted_val"):
            for c in ("n01440764", "n01443537"):
                os.makedirs(root / name / c)
                for i in range(2):
                    n = int(rng.integers(100, 400))
                    ev = np.zeros(n, dtype=rec)
                    ev["x"], ev["y"] = rng.integers(0, 640, n), rng.integers(0, 480, n)
                    ev["t"], ev["p"] = np.sort(rng.integers(0, 10**6, n)), rng.integers(0, 2, n)
                    np.savez(root / name / c / f"{c}_{i}.npz", event_data=ev)
        return []
    # the reference takes the sequences to process from --class_folder, or
    # else from the input's own listing (which holds the split folders)
    h5py = pytest.importorskip("h5py")
    for split_name, seq in (("train_events", "zurich_city_00_a"),
                            ("train_events", "zurich_city_01_a"),
                            ("test_events", "zurich_city_00_a")):
        d = root / split_name / seq / "events" / "right"
        os.makedirs(d)
        n = 20000
        t = np.sort(rng.integers(0, 400_000, n)).astype(np.int64)
        with h5py.File(d / "events.h5", "w") as f:
            g = f.create_group("events")
            g["t"], g["x"] = t, rng.integers(0, 640, n).astype(np.uint16)
            g["y"], g["p"] = (rng.integers(0, 480, n).astype(np.uint16),
                              rng.integers(0, 2, n).astype(np.uint8))
            f["ms_to_idx"] = np.searchsorted(t, np.arange(int(t[-1] // 1000) + 2) * 1000)
            f["t_offset"] = np.int64(5_000_000)
    return ["--class_folder", "zurich_city_00_a"]


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture(scope="module", params=["ncaltech101", "ncars", "nimagenet", "dsec"])
def raw_and_reference(request, tmp_path_factory):
    """The raw tree and the JAX package's output on it (one core)."""
    dataset = request.param
    base = tmp_path_factory.mktemp(dataset)
    raw = base / "raw"
    raw.mkdir()
    extra = _write_raw(raw, dataset, np.random.default_rng(7))
    out = base / "reference"
    _jax_process(["--dataset", dataset, "--input", str(raw), "--output", str(out), *extra])
    return dataset, raw, extra, _tree(out), base


def _jax_process(argv):
    """The JAX package's CLI, which reads sys.argv."""
    saved = sys.argv
    sys.argv = ["process_dataset", *argv]
    try:
        jax_process_dataset.main()
    finally:
        sys.argv = saved


@pytest.mark.parametrize("cores,library", [(1, True), (2, True), (1, False)])
def test_process_dataset_matches_jax(raw_and_reference, cores, library, monkeypatch):
    dataset, raw, extra, want, base = raw_and_reference
    if not library:   # as where libmemev does not build: the numpy decoders
        monkeypatch.setattr(native, "decode_atis", lambda buf: None)
        monkeypatch.setattr(native, "decode_ncars", lambda buf: None)
    out = base / f"port_{cores}_{'native' if library else 'numpy'}"
    process_dataset.main(["--dataset", dataset, "--input", str(raw), "--output", str(out),
                          "--cores", str(cores), *extra])
    got = _tree(out)
    assert want, "the reference wrote nothing"
    assert sorted(got) == sorted(want)
    assert all(got[k] == want[k] for k in want)
    if dataset == "ncaltech101":
        # the split routing: 4 train and 1 val file a class, the 6th skipped
        assert sum(k.startswith("train") for k in got) == 4 * len(CLASSES)
        assert sum(k.startswith("val") for k in got) == len(CLASSES)


def test_process_dataset_class_folder(raw_and_reference):
    dataset, raw, extra, _, base = raw_and_reference
    if dataset == "dsec":
        folder = "zurich_city_01_a"
    else:
        folder = sorted(os.listdir(raw if dataset == "ncaltech101" else
                                   raw / os.listdir(raw)[0]))[0]
    extra = [f for f in extra if f not in ("--class_folder", "zurich_city_00_a")]
    flags = ["--input", str(raw), "--class_folder", folder, "--dataset", dataset, *extra]
    _jax_process(flags + ["--output", str(base / "reference_one_folder")])
    process_dataset.main(flags + ["--output", str(base / "port_one_folder")])
    want, got = _tree(base / "reference_one_folder"), _tree(base / "port_one_folder")
    assert want and got == want
    assert all(folder in k for k in got)


def test_make_subsets_writes_identical_files(tmp_path):
    rng = np.random.default_rng(3)
    lines = [f"{'val' if i % 4 == 0 else 'train'}/c{c}/image_{i:04d}.npy" for c in range(5)
             for i in range(int(rng.integers(3, 40)))]
    split = tmp_path / "ncaltech101.txt"
    split.write_text("\n".join(lines) + "\n\n")
    for mod, out in ((jax_make_subsets, "ref"), (make_subsets, "port")):
        mod.main(["--split", str(split), "--fractions", "0.02", "0.1", "0.5", "1.0",
                  "--output_dir", str(tmp_path / out), "--seed", "4"])
    want, got = _tree(tmp_path / "ref"), _tree(tmp_path / "port")
    assert len(want) == 4 and got == want


# -- the round trip that stands in for export_torch ----------------------------

def _processed_caltech(tmp_path):
    raw = tmp_path / "raw"
    raw.mkdir()
    extra = _write_raw(raw, "ncaltech101", np.random.default_rng(11))
    out = tmp_path / "ncaltech101"
    process_dataset.main(["--dataset", "ncaltech101", "--input", str(raw), "--output",
                          str(out), "--cores", "2", *extra])
    return str(out)


_SIZE = ["--input_H", "32", "--input_W", "32", "--num_layers", "2", "--transformer_emb", "32",
         "--transformer_depth", "2", "--transformer_heads", "4", "--device", "cpu",
         "--num_workers", "0", "--slice_max_evs", "1500", "--warmup_steps", "1",
         "--max_random_shift_evs", "2"]


def test_finetune_on_processed_tree_round_trips_through_import(tmp_path, capsys):
    from mem_tpu_torch.cli import run_class_finetuning as F
    from mem_tpu_torch.cli.common import build_classifier
    from mem_tpu_torch.models.registry import create_model

    data = _processed_caltech(tmp_path)
    pt = create_model("pt_vit", img_size=(32, 32), patch_size=(4, 4), embed_dim=32, depth=2,
                      num_heads=4, vocab_size=32, use_shared_rel_pos_bias=True)
    pt.init_weights(torch.Generator().manual_seed(1))
    torch.save({"model": pt.state_dict(), "epoch": 0}, tmp_path / "pt.pth")
    flags = ["--config", os.path.join(REPO, "configs", "ncaltech.conf"), "--data_path", data,
             "--finetune", str(tmp_path / "pt.pth"), "--output_dir", str(tmp_path / "ft"),
             "--dtype", "float32", "--batch_size", "4", "--update_freq", "1",
             "--save_ckpt_freq", "1", "--opt", "lookahead_adamp", "--pretrained", "1",
             "--epochs", "2", "--init_scale", "1.0", *_SIZE]
    r = F.main(flags)
    assert "model = ft_vit. pretrained = True" in capsys.readouterr().out
    # 12 training files / 4 = 3 steps an epoch; Lookahead syncs at step 6
    assert len(r["history"]) >= 1 and all(np.isfinite(h[1]) for h in r["history"])
    pay = torch.load(tmp_path / "ft" / "checkpoint-1.pth", weights_only=True)
    assert pay["optimizer"]["lookahead_count"] == 6
    args = F.get_args(flags)
    port = build_classifier(args, 3, torch.float32, torch.device("cpu"))
    port.load_state_dict(pay["model"], strict=True)
    tree = import_vit_state_dict(pay["model"], is_pretrain=False)
    fmodel = jax_create_model(
        "ft_vit", num_classes=3, use_mean_pooling=bool(args.use_mean_pooling),
        init_scale=args.init_scale, use_rel_pos_bias=bool(args.rel_pos_bias),
        use_abs_pos_emb=bool(args.abs_pos_emb), init_values=args.layer_scale_init_value,
        img_size=(32, 32), patch_size=(4, 4), embed_dim=32, depth=2, num_heads=4,
        mlp_ratio=args.transformer_mlp_ratio, dtype=jnp.float32)
    x = np.random.default_rng(2).random((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(fmodel.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x)))
    got = port.eval()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_pretraining_checkpoint_round_trips_through_import(tmp_path):
    from mem_tpu_torch.cli import run_mem_pretraining as R
    from mem_tpu_torch.models.discrete_vae import DiscreteVAE

    data = _processed_caltech(tmp_path)
    vae = DiscreteVAE((32, 32), num_tokens=32, codebook_dim=8, num_layers=2,
                      num_resnet_blocks=1, hidden_dim=16)
    torch.save({"model": vae.state_dict(), "hparams": dict(
        input_H=32, input_W=32, num_tokens=32, emb_dim=8, num_layers=2, num_resnet_blocks=1,
        hidden_dim=16, channels=3, loss="mse")}, tmp_path / "vae.pth")
    flags = ["--config", os.path.join(REPO, "configs", "ncaltech.conf"), "--data_path", data,
             "--discrete_vae_weight_path", str(tmp_path / "vae.pth"), "--output_dir",
             str(tmp_path / "pt"), "--num_tokens", "32", "--num_mask_patches", "20",
             "--mask_pool_size", "16", "--batch_size", "4", "--epochs", "1",
             "--opt", "nadam", *_SIZE]
    R.main(flags)
    pay = torch.load(tmp_path / "pt" / "checkpoint-final.pth", weights_only=True)
    args = R.get_args(flags)
    port = R.build_model(args, torch.float32, torch.device("cpu"))
    port.load_state_dict(pay["model"], strict=True)
    tree = import_vit_state_dict(pay["model"], is_pretrain=True)
    fmodel = jax_create_model(
        "pt_vit", img_size=(32, 32), patch_size=(4, 4), embed_dim=32, depth=2, num_heads=4,
        vocab_size=32, init_values=args.layer_scale_init_value,
        use_shared_rel_pos_bias=bool(args.rel_pos_bias), use_abs_pos_emb=bool(args.abs_pos_emb),
        num_masked_tokens=20, dtype=jnp.float32)
    rng = np.random.default_rng(5)
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    mask = np.zeros((2, 64), bool)
    mask[:, rng.choice(64, 20, replace=False)] = True
    want_logits, want_idx = fmodel.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                                         jnp.asarray(mask))
    got_logits, got_idx = port.eval()(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(got_logits.detach().numpy(), np.asarray(want_logits),
                               rtol=1e-4, atol=1e-5)
