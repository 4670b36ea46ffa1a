"""Warm start from a timm ViT checkpoint (the reference's ``--pretrained``
path, run_mem_pretraining.py:194-222), the port's own copy of
mem_tpu/utils/timm_init.py on the port's module names.

The reference downloads timm's ``vit_base_patch16_224`` and copies
patch_embed, the per-block norms, attention and MLP weights and the final
norm into the pretraining model: not the qkv biases (the decomposed-bias
scheme differs), not the position embeddings. Without network access the
checkpoint is a local file, ``--init_ckpt`` (a ``.pth`` / ``.pt`` state_dict,
optionally under ``"model"``, or an ``.npz`` of timm-named arrays).
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch


def load_timm_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A timm-named state_dict as numpy arrays."""
    if path.endswith(".npz"):
        return dict(np.load(path))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


# timm block keys -> the port's pt_vit keys under blocks.{i}. (the qkv
# biases are not copied)
_BLOCK_KEYS = ("norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias",
               "attn.qkv.weight", "attn.proj.weight", "attn.proj.bias",
               "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias")


def warm_start_from_timm(model: torch.nn.Module, sd: Dict[str, np.ndarray]) -> list:
    """Copy the timm subset the reference copies (run_mem_pretraining.py:
    203-222) into ``model`` (a pt_vit) in place: patch_embed.proj, the
    blocks' norm1 / norm2, attn.qkv.weight, attn.proj, mlp.fc1 / fc2 and the
    final norm. cls / mask tokens, rel-pos tables, lm_head and the qkv
    biases stay. A tensor whose shape differs is skipped and printed, as the
    JAX function does. Returns the names copied."""
    own = model.state_dict()
    names = [k for k in ("patch_embed.proj.weight", "patch_embed.proj.bias") if k in sd]
    for key in sd:
        m = re.match(r"blocks\.(\d+)\.(.*)", key)
        if m and m.group(2) in _BLOCK_KEYS:
            names.append(key)
    if "norm.weight" in sd and "norm.weight" in own:
        names += ["norm.weight", "norm.bias"]
    copied = []
    with torch.no_grad():
        for k in names:
            if k not in own:
                raise KeyError(f"timm warm start: the model has no {k}")
            v = torch.as_tensor(np.asarray(sd[k]))
            if tuple(v.shape) != tuple(own[k].shape):
                print(f"timm warm-start: skip {k} {tuple(v.shape)} vs {tuple(own[k].shape)}")
                continue
            own[k].copy_(v)
            copied.append(k)
    return copied
