"""Export one of the port's checkpoints as a reference-style PyTorch .pth,
port of mem_tpu/cli/export_torch.py.

The port's training CLIs already keep their weights in the reference's torch
names (``export_vit_params``, ``export_mae_params`` and
``export_mae_classifier_params`` of mem_tpu/utils/torch_import.py:122, 176,
214), so the export reads a ``.pth`` (``{"model": state_dict, "epoch": n,
...}``; a directory: its newest ``.pth``), keeps the model's tensors under
those names, and writes ``{--key: tensors, "epoch": n}`` without the
optimizer, the EMA or anything else. ``--model_type auto`` sniffs the family
by the reference's rule (export_torch.py:43-54) on the port's names: a
decoder (``decoder_embed.*`` / ``decoder_blocks.*``) is the MAE, flat timm
blocks (``blocks.N.qkv.weight``, no ``attn.``) the ``--MAE 1`` finetune
classifier, anything else the BEiT-style pt_vit / ft_vit.

Usage:
  python -m mem_tpu_torch.cli.export_torch --checkpoint pt_out/checkpoint-final.pth \\
      --output mem_pretrain.pth [--key model]
"""
from __future__ import annotations

import argparse
import os
import re


def sniff(state_dict: dict) -> str:
    """"mae", "mae_classifier" or "vit" (export_torch.py:43-54)."""
    keys = list(state_dict)
    if any(k.startswith(("decoder_embed.", "decoder_blocks.")) for k in keys):
        return "mae"
    if any(re.fullmatch(r"blocks\.\d+\.qkv\.weight", k) for k in keys):
        return "mae_classifier"
    return "vit"


def export_state_dict(state_dict: dict) -> dict:
    """The model's tensors as contiguous CPU copies, under their names (the
    port's state_dicts are the reference's schema already)."""
    import torch

    return {k: v.detach().to("cpu").contiguous().clone()
            for k, v in state_dict.items() if torch.is_tensor(v)}


def main(argv=None):
    p = argparse.ArgumentParser("export a mem-tpu-torch checkpoint to a reference torch .pth")
    p.add_argument("--checkpoint", required=True,
                   help="a .pth of the port's CLIs, or a directory (its newest .pth)")
    p.add_argument("--output", required=True)
    p.add_argument("--key", default="model",
                   help="top-level state_dict key (reference uses 'model')")
    p.add_argument("--model_type", default="auto",
                   choices=("auto", "vit", "mae", "mae_classifier"),
                   help="parameter family; auto sniffs it: the MAE has decoder_* "
                        "weights, the --MAE 1 finetune classifier flat timm blocks "
                        "(blocks.N.qkv), everything else is the BEiT-style pt_vit / "
                        "ft_vit surface")
    args = p.parse_args(argv)

    import torch

    from mem_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint

    path = args.checkpoint
    if os.path.isdir(path):
        path = latest_checkpoint(path) or path
    payload = load_checkpoint(path)
    sd = payload["model"] if "model" in payload else payload
    kind = sniff(sd) if args.model_type == "auto" else args.model_type
    print(f"exporting as {kind}")
    tensors = export_state_dict(sd)
    torch.save({args.key: tensors, "epoch": int(payload.get("epoch", -1))}, args.output)
    print(f"wrote {len(tensors)} tensors to {args.output}")
    return kind


if __name__ == "__main__":
    main()
