"""Carry ``ft_vit`` weights from a flax parameter tree into the port.

The state_dict keys are the reference's torch schema, the one
mem_tpu/utils/torch_import.py ``export_vit_params`` (:122-173) writes and
``python -m mem_tpu.cli.export_torch`` saves, so the port's
``VisionTransformer.load_state_dict(sd, strict=True)`` takes either. Flax
Dense kernels are (in, out) and torch Linear weights (out, in); the patch
conv kernel (kh, kw, C, D) becomes the torch (D, C, kh, kw).
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch


def from_jax_params(tree: Dict) -> Dict[str, torch.Tensor]:
    """flax variables ``{"params": ..., ["batch_stats": ...]}`` with numpy
    (or array-like) leaves -> torch state_dict for the port's ft_vit. The
    linear probe's BatchNorm running statistics come from ``batch_stats``."""
    p = tree["params"]
    sd: Dict[str, torch.Tensor] = {}

    def put(name, v, transpose=None):
        a = np.asarray(v)
        if transpose is not None:
            a = np.transpose(a, transpose)
        sd[name] = torch.from_numpy(np.array(a, copy=True, order="C"))

    if "patch_embed" in p:
        put("patch_embed.proj.weight", p["patch_embed"]["proj"]["kernel"], (3, 2, 0, 1))
        put("patch_embed.proj.bias", p["patch_embed"]["proj"]["bias"])
    for key in ("cls_token", "mask_token", "pos_embed"):
        if key in p:
            put(key, p[key])
    enc = p.get("encoder", {})
    if "rel_pos_bias" in enc:
        put("rel_pos_bias.relative_position_bias_table",
            enc["rel_pos_bias"]["relative_position_bias_table"])
    for name, sub in enc.items():
        m = re.fullmatch(r"blocks_(\d+)", name)
        if not m:
            continue
        b = f"blocks.{m.group(1)}"
        for ln in ("norm1", "norm2"):
            put(f"{b}.{ln}.weight", sub[ln]["scale"])
            put(f"{b}.{ln}.bias", sub[ln]["bias"])
        attn = sub["attn"]
        put(f"{b}.attn.qkv.weight", attn["qkv_kernel"], (1, 0))
        if "q_bias" in attn:
            put(f"{b}.attn.q_bias", attn["q_bias"])
            put(f"{b}.attn.v_bias", attn["v_bias"])
        put(f"{b}.attn.proj.weight", attn["proj"]["kernel"], (1, 0))
        put(f"{b}.attn.proj.bias", attn["proj"]["bias"])
        if "rel_pos" in attn:
            put(f"{b}.attn.relative_position_bias_table",
                attn["rel_pos"]["relative_position_bias_table"])
        for fc in ("fc1", "fc2"):
            put(f"{b}.mlp.{fc}.weight", sub["mlp"][fc]["kernel"], (1, 0))
            put(f"{b}.mlp.{fc}.bias", sub["mlp"][fc]["bias"])
        if "gamma_1" in sub:
            put(f"{b}.gamma_1", sub["gamma_1"])
            put(f"{b}.gamma_2", sub["gamma_2"])
    for nm in ("norm", "fc_norm"):
        if nm in p:
            put(f"{nm}.weight", p[nm]["scale"])
            put(f"{nm}.bias", p[nm]["bias"])
    if "head" in p:
        put("head.weight", p["head"]["kernel"], (1, 0))
        put("head.bias", p["head"]["bias"])
    bn = tree.get("batch_stats", {}).get("batch_norm")
    if bn is not None:
        put("batch_norm.running_mean", bn["mean"])
        put("batch_norm.running_var", bn["var"])
    return sd
