"""The timm warm starts of the port held against the JAX package's:
``warm_start_from_timm`` on a seeded timm-named dict (the subset it copies,
the shape mismatch it skips), ``run_mem_pretraining --bf16_moments 1
--pretrained 1 --init_ckpt`` on the CPU loading what the JAX function loads,
``load_timm_npz`` on a seeded jax-ViT .npz, and the segmentation backbone
that ``train_seg --pretrained x.npz`` builds from it against the JAX
importer and surgery."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mem_tpu.models import segmentation as jseg
from mem_tpu.models.registry import create_model as jax_create_model
from mem_tpu.utils import surgery as jax_surgery
from mem_tpu.utils import timm_init as jax_timm_init
from mem_tpu.utils import torch_import as jax_torch_import
from mem_tpu_torch.models.registry import create_model
from mem_tpu_torch.models.segmentation import build_segmentor
from mem_tpu_torch.utils import timm_init
from mem_tpu_torch.utils.weights import from_jax_params, load_timm_npz, seg_from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, DEPTH, HEADS = 32, 2, 4


def _timm_dict(rng, depth=DEPTH, wrong=()):
    """A timm ``vit_base``-named state_dict at width D (torch layouts), with
    what the warm start must leave alone (qkv biases, cls / pos, head) and
    the keys in ``wrong`` drawn in another shape."""
    shapes = {"patch_embed.proj.weight": (D, 3, 4, 4), "patch_embed.proj.bias": (D,),
              "cls_token": (1, 1, D), "pos_embed": (1, 65, D), "norm.weight": (D,),
              "norm.bias": (D,), "head.weight": (10, D), "head.bias": (10,)}
    for i in range(depth):
        b = f"blocks.{i}"
        shapes.update({f"{b}.norm1.weight": (D,), f"{b}.norm1.bias": (D,),
                       f"{b}.norm2.weight": (D,), f"{b}.norm2.bias": (D,),
                       f"{b}.attn.qkv.weight": (3 * D, D), f"{b}.attn.qkv.bias": (3 * D,),
                       f"{b}.attn.proj.weight": (D, D), f"{b}.attn.proj.bias": (D,),
                       f"{b}.mlp.fc1.weight": (4 * D, D), f"{b}.mlp.fc1.bias": (4 * D,),
                       f"{b}.mlp.fc2.weight": (D, 4 * D), f"{b}.mlp.fc2.bias": (D,)})
    return {k: rng.standard_normal(tuple(s) + ((1,) if k in wrong else ())).astype(np.float32)
            for k, s in shapes.items()}


def _pt_pair(rng):
    fmodel = jax_create_model("pt_vit", dtype=jnp.float32, img_size=(32, 32), patch_size=(4, 4),
                              in_chans=3, vocab_size=32, embed_dim=D, depth=DEPTH,
                              num_heads=HEADS, init_values=0.1, use_shared_rel_pos_bias=True)
    params = jax.device_get(jax.jit(fmodel.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                                                 jnp.zeros((1, 64), bool)))
    params = jax.tree.map(lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32),
                          params)
    tmodel = create_model("pt_vit", img_size=(32, 32), patch_size=(4, 4), in_chans=3,
                          vocab_size=32, embed_dim=D, depth=DEPTH, num_heads=HEADS,
                          init_values=0.1, use_shared_rel_pos_bias=True)
    tmodel.load_state_dict(from_jax_params(params), strict=True)
    return params, tmodel


def test_warm_start_matches_jax(rng, capsys):
    params, tmodel = _pt_pair(rng)
    sd = _timm_dict(rng, wrong=("blocks.1.mlp.fc1.weight",))
    want = from_jax_params(jax_timm_init.warm_start_from_timm(params, sd))
    jax_out = capsys.readouterr().out
    copied = timm_init.warm_start_from_timm(tmodel, sd)
    assert "skip blocks.1.mlp.fc1.weight" in capsys.readouterr().out
    assert "skip" in jax_out
    got = tmodel.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    before = from_jax_params(params)
    moved = {k for k in got if not torch.equal(got[k], before[k])}
    assert moved == set(copied)
    assert {"blocks.0.attn.qkv.weight", "norm.weight", "patch_embed.proj.bias"} <= moved
    assert not moved & {"cls_token", "pos_embed", "mask_token", "blocks.0.attn.q_bias",
                        "blocks.1.mlp.fc1.weight", "lm_head.weight"}


@pytest.mark.parametrize("fmt", [".pth", ".npz"])
def test_load_timm_state_dict_matches_jax(rng, tmp_path, fmt):
    sd = _timm_dict(rng)
    path = str(tmp_path / f"timm{fmt}")
    if fmt == ".pth":
        torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    else:
        np.savez(path, **sd)
    got, want = timm_init.load_timm_state_dict(path), jax_timm_init.load_timm_state_dict(path)
    assert set(got) == set(want) == set(sd)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_pretraining_cli_warm_starts_with_bf16_moments(rng, tmp_path, capsys):
    """The CLI at lr 0 for one epoch on the CPU: its final checkpoint holds
    the JAX function's warm start of the CLI's own seeded initialisation,
    and bf16 moments."""
    from mem_tpu_torch.cli import run_mem_pretraining as R
    from mem_tpu_torch.models.discrete_vae import DiscreteVAE

    root = tmp_path / "ncaltech101"
    for split, n in (("train", 8), ("val", 4)):
        for i in range(n):
            d = root / split / f"c{i % 2}"
            d.mkdir(parents=True, exist_ok=True)
            m = int(rng.integers(300, 1500))
            ev = np.stack([rng.integers(0, 30, m), rng.integers(0, 24, m),
                           np.sort(rng.integers(0, 10**5, m)), rng.choice([-1.0, 1.0], m)], 1)
            np.save(d / f"s{i}.npy", ev.astype(np.float64))
    vae = DiscreteVAE((32, 32), num_tokens=32, codebook_dim=8, num_layers=2,
                      num_resnet_blocks=1, hidden_dim=16)
    torch.save({"model": vae.state_dict(), "hparams": dict(
        input_H=32, input_W=32, num_tokens=32, emb_dim=8, num_layers=2, num_resnet_blocks=1,
        hidden_dim=16, channels=3, loss="mse")}, tmp_path / "vae.pth")
    sd = _timm_dict(rng)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "timm.pth")
    flags = ["--config", os.path.join(REPO, "configs", "ncaltech.conf"), "--data_path",
             str(root), "--discrete_vae_weight_path", str(tmp_path / "vae.pth"),
             "--output_dir", str(tmp_path / "out"), "--device", "cpu", "--input_H", "32",
             "--input_W", "32", "--num_layers", "2", "--transformer_emb", str(D),
             "--transformer_depth", str(DEPTH), "--transformer_heads", str(HEADS),
             "--num_tokens", "32", "--num_mask_patches", "20", "--mask_pool_size", "16",
             "--batch_size", "4", "--num_workers", "0", "--slice_max_evs", "1500",
             "--max_random_shift_evs", "2", "--epochs", "1", "--warmup_steps", "1",
             "--lr", "0", "--warmup_lr", "0", "--min_lr", "0",
             "--bf16_moments", "1", "--pretrained", "1", "--init_ckpt",
             str(tmp_path / "timm.pth")]
    R.main(flags)
    assert "warm-started encoder from" in capsys.readouterr().out
    pay = torch.load(tmp_path / "out" / "checkpoint-final.pth", weights_only=True)
    states = pay["optimizer"]["state"].values()
    assert states and all(st["exp_avg"].dtype == torch.bfloat16 for st in states)
    # what the JAX function loads onto the same initialisation
    args = R.get_args(flags)
    init = R.build_model(args, torch.float32, torch.device("cpu"))
    init.init_weights(torch.Generator().manual_seed(args.seed))
    tree = jax_torch_import.import_vit_state_dict(init.state_dict(), is_pretrain=True)
    want = from_jax_params(jax_timm_init.warm_start_from_timm(tree, sd))
    for k, v in pay["model"].items():
        assert torch.equal(v, want[k]), k
    assert torch.equal(pay["model"]["blocks.1.attn.qkv.weight"],
                       torch.from_numpy(sd["blocks.1.attn.qkv.weight"]))


def test_warm_start_is_refused_under_mae():
    from mem_tpu_torch.cli import run_mem_pretraining as R

    with pytest.raises(ValueError, match="MAE has no such path"):
        R.check_ported(R.get_args(["--data_path", "x", "--MAE", "1", "--pretrained", "1",
                                   "--init_ckpt", "t.pth"]))


# -- the jax-ViT .npz ---------------------------------------------------------

def _jax_vit_npz(rng, path, depth=DEPTH, hd=8):
    H = D // hd
    z = {"embedding/kernel": (16, 16, 3, D), "embedding/bias": (D,), "cls": (1, 1, D),
         "Transformer/posembed_input/pos_embedding": (1, 197, D),
         "Transformer/encoder_norm/scale": (D,), "Transformer/encoder_norm/bias": (D,),
         "head/kernel": (D, 10), "head/bias": (10,), "pre_logits/kernel": (D, D),
         "pre_logits/bias": (D,)}
    for i in range(depth):
        b = f"Transformer/encoderblock_{i}"
        a = f"{b}/MultiHeadDotProductAttention_1"
        for ln in ("LayerNorm_0", "LayerNorm_2"):
            z[f"{b}/{ln}/scale"], z[f"{b}/{ln}/bias"] = (D,), (D,)
        for n in ("query", "key", "value"):
            z[f"{a}/{n}/kernel"], z[f"{a}/{n}/bias"] = (D, H, hd), (H, hd)
        z[f"{a}/out/kernel"], z[f"{a}/out/bias"] = (H, hd, D), (D,)
        z[f"{b}/MlpBlock_3/Dense_0/kernel"], z[f"{b}/MlpBlock_3/Dense_0/bias"] = (D, 4 * D), (4 * D,)
        z[f"{b}/MlpBlock_3/Dense_1/kernel"], z[f"{b}/MlpBlock_3/Dense_1/bias"] = (4 * D, D), (D,)
    np.savez(path, **{k: rng.standard_normal(s).astype(np.float32) for k, s in z.items()})


def test_load_timm_npz_matches_jax(rng, tmp_path):
    path = str(tmp_path / "vit.npz")
    _jax_vit_npz(rng, path)
    got, want = load_timm_npz(path), jax_torch_import.load_timm_npz(path)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    z = dict(np.load(path))
    np.savez(tmp_path / "bad.npz", **{k: v for k, v in z.items() if "encoderblock" not in k})
    with pytest.raises(ValueError, match="not a jax-ViT"):
        load_timm_npz(str(tmp_path / "bad.npz"))


def test_seg_backbone_from_npz_matches_jax(rng, tmp_path):
    """``train_seg --pretrained x.npz``'s backbone load against the JAX
    importer and surgery onto the same segmentor."""
    from mem_tpu_torch.cli.train_seg import load_pretrained_backbone

    path = str(tmp_path / "vit.npz")
    _jax_vit_npz(rng, path)
    fmodel = jseg.EncoderDecoder(
        num_classes=3, dtype=jnp.float32,
        backbone_cfg=dict(img_size=64, embed_dim=D, depth=DEPTH, num_heads=2,
                          out_indices=(0, 0, 0, 1), drop_path_rate=0.0))
    variables = jax.device_get(jax.jit(fmodel.init)(jax.random.key(1),
                                                    jnp.zeros((1, 44, 64, 3))))
    src = jax_torch_import.import_vit_state_dict(jax_torch_import.load_timm_npz(path),
                                                 is_pretrain=False)
    merged = jax_surgery.surgery_for_finetune(
        src, {"params": variables["params"]["backbone"]}, dst_window=(4, 4))
    want = seg_from_jax_params({"params": {**variables["params"], "backbone": merged["params"]},
                                "batch_stats": variables["batch_stats"]})
    model = build_segmentor(3, 64, D, DEPTH, 2, torch.float32, torch.device("cpu"),
                            drop_path_rate=0.0)
    model.load_state_dict(seg_from_jax_params(variables), strict=True)
    load_pretrained_backbone(model, path, "model|module", 64)
    got = model.state_dict()
    template = seg_from_jax_params(variables)
    changed = 0
    for k, v in want.items():
        assert torch.equal(got[k], v), k
        changed += int(not torch.equal(v, template[k]))
    assert changed >= 20
    assert torch.equal(got["backbone.blocks.1.attn.qkv.weight"],
                       torch.from_numpy(load_timm_npz(path)["blocks.1.attn.qkv.weight"]))


def test_train_seg_cli_loads_the_npz(rng, tmp_path, capsys):
    """``train_seg --pretrained x.npz --max_iters 0`` on the CPU: the final
    checkpoint's backbone is ``load_pretrained_backbone`` of the CLI's own
    seeded segmentor (held against the JAX importer above)."""
    from PIL import Image

    from mem_tpu_torch.cli import train_seg
    from mem_tpu_torch.utils.checkpoint import load_checkpoint

    root = tmp_path / "dsec"
    for split in ("train", "val"):
        (root / "imgs" / split / "seq0").mkdir(parents=True)
        (root / "anns" / split / "seq0").mkdir(parents=True)
        ev = np.stack([rng.integers(0, 640, 20000), rng.integers(0, 480, 20000),
                       np.zeros(20000), rng.integers(0, 2, 20000)], 1).astype(np.float32)
        np.save(root / "imgs" / split / "seq0" / "000000.npy", ev)
        Image.fromarray(np.zeros((440, 640), np.uint8)).save(
            root / "anns" / split / "seq0" / "000000.png")
    path = str(tmp_path / "vit.npz")
    _jax_vit_npz(rng, path)
    out = tmp_path / "out"
    train_seg.main(["--data_root", str(root), "--num_classes", "3", "--seg_input_size", "64",
                    "--embed_dim", str(D), "--depth", str(DEPTH), "--num_heads", "2",
                    "--dtype", "float32", "--device", "cpu", "--batch_size", "1",
                    "--output_dir", str(out), "--max_iters", "0", "--pretrained", path,
                    "--num_workers", "1"])
    assert "backbone initialized from" in capsys.readouterr().out
    args = train_seg.get_args(["--data_root", str(root)])
    model = build_segmentor(3, 64, D, DEPTH, 2, torch.float32, torch.device("cpu"),
                            drop_path_rate=args.drop_path)
    model.init_weights(torch.Generator().manual_seed(args.seed))
    train_seg.load_pretrained_backbone(model, path, args.model_key, 64)
    got = load_checkpoint(str(out / "checkpoint-final.pth"))["model"]
    for k, v in model.state_dict().items():
        if k.startswith("backbone."):
            assert torch.equal(got[k], v), k
