"""The port's cli/export_torch against mem_tpu.cli.export_torch: one set of
flax weights saved both ways (an orbax checkpoint for the JAX package's
export, the port's .pth of the same weights for the port's), exported with
--model_type auto; the two .pth files hold the same keys, bit-equal tensors
and the same epoch, and both CLIs sniff the same family (pt_vit, the MAE and
the --MAE 1 finetune classifier)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

IMG, PATCH, DIM, DEPTH, HEADS = 32, 8, 32, 2, 2


def _variables(kind):
    if kind == "vit":
        from mem_tpu.models import create_model

        model = create_model("pt_vit", vocab_size=32, img_size=(IMG, IMG),
                             patch_size=(PATCH, PATCH), embed_dim=DIM, depth=DEPTH,
                             num_heads=HEADS, init_values=0.1, use_shared_rel_pos_bias=True)
        return jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)),
                                   jnp.zeros((1, 16), bool))
    if kind == "mae":
        from mem_tpu.models.mae import MaskedAutoencoderViT

        mae = MaskedAutoencoderViT(img_size=IMG, patch_size=PATCH, embed_dim=DIM, depth=DEPTH,
                                   num_heads=HEADS, decoder_embed_dim=32, decoder_depth=1,
                                   decoder_num_heads=2)
        return mae.init({"params": jax.random.key(0), "mask": jax.random.key(1)},
                        jnp.zeros((1, IMG, IMG, 3)))
    from mem_tpu.models.mae_classifier import MAEVisionTransformer

    clf = MAEVisionTransformer(img_size=(IMG, IMG), patch_size=PATCH, num_classes=5,
                               embed_dim=DIM, depth=DEPTH, num_heads=HEADS)
    return jax.jit(clf.init)(jax.random.key(7), jnp.zeros((1, IMG, IMG, 3)))


def _port_state_dict(kind, variables):
    from mem_tpu_torch.utils import weights

    fn = {"vit": weights.from_jax_params, "mae": weights.mae_from_jax_params,
          "mae_classifier": weights.mae_classifier_from_jax_params}[kind]
    return fn(jax.device_get(variables))


@pytest.mark.parametrize("kind", ["vit", "mae", "mae_classifier"])
def test_export_equals_the_jax_package_export(tmp_path, capsys, kind):
    from mem_tpu.cli.export_torch import main as jax_export
    from mem_tpu.utils.checkpoint import save_checkpoint
    from mem_tpu_torch.cli import export_torch

    variables = jax.tree.map(np.asarray, _variables(kind))
    ck = save_checkpoint(str(tmp_path / "orbax"), "final", {"params": variables, "epoch": 7})
    jax_export(["--checkpoint", ck, "--output", str(tmp_path / "jax.pth")])
    assert f"exporting as {kind}" in capsys.readouterr().out

    torch.save({"model": _port_state_dict(kind, variables), "optimizer": {"state": {}},
                "epoch": 7}, tmp_path / "port.pth")
    got_kind = export_torch.main(["--checkpoint", str(tmp_path / "port.pth"),
                                  "--output", str(tmp_path / "out.pth")])
    assert got_kind == kind and f"exporting as {kind}" in capsys.readouterr().out

    want = torch.load(tmp_path / "jax.pth", weights_only=True)
    got = torch.load(tmp_path / "out.pth", weights_only=True)
    assert set(got) == {"model", "epoch"} and got["epoch"] == want["epoch"] == 7
    assert set(got["model"]) == set(want["model"])
    for k, v in want["model"].items():
        assert got["model"][k].dtype == v.dtype and torch.equal(got["model"][k], v), k


def test_export_reads_a_directory_and_takes_an_explicit_key(tmp_path):
    """A directory resolves to its newest .pth; --key names the top-level
    entry; --model_type overrides the sniff."""
    from mem_tpu_torch.cli import export_torch

    sd = _port_state_dict("vit", jax.tree.map(np.asarray, _variables("vit")))
    (tmp_path / "run").mkdir()
    torch.save({"model": sd, "epoch": 2}, tmp_path / "run" / "checkpoint-2.pth")
    kind = export_torch.main(["--checkpoint", str(tmp_path / "run"), "--output",
                              str(tmp_path / "o.pth"), "--key", "module",
                              "--model_type", "vit"])
    out = torch.load(tmp_path / "o.pth", weights_only=True)
    assert kind == "vit" and set(out) == {"module", "epoch"} and out["epoch"] == 2
    assert export_torch.sniff(sd) == "vit"
