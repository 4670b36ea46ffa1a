"""AdamW with layer decay, port of mem_tpu/train/optim.py
``create_optimizer(opt="adamw")`` / ``scheduled_adamw`` (:113-178) and its
layer-id rules (:36-100).

``torch.optim.AdamW`` over parameter groups keyed by (lr scale, decays).
Weight decay is split as ``build_wd_mask_tree`` (:86-100) splits the flax
tree: no decay for 1-D parameters, ``*bias`` and ``cls_token`` /
``pos_embed``; ``mask_token`` (3-D) and the 2-D relative-position tables are
decayed. The lr scale is BEiT's layer decay (``build_lr_scale_tree``,
:74-83): ``decay ** (L + 1 - i)`` with layer id i = 0 for the patch embedding
and the cls / mask / pos tokens, n + 1 for block n, and L + 1 for the rest
(final norm, heads, necks, a shared rel-pos table); without layer decay
every scale is 1 and the groups are the two of pretraining. The finetune
recipe adds a cosine weight-decay schedule (the caller passes wd[t]), the
rel-pos tables as extra no-decay names, and the linear probe's frozen
backbone (lr scale 0 off the head). Betas default
to (0.9, 0.95) (the reference's pretraining override, optim_factory.py:121);
segmentation passes (0.9, 0.999). Each step the caller writes lr[t] * scale
and wd[t] into the groups (:167-173) and clips by global norm with factor
clip / (norm + 1e-6) before the moments (:152-155); the reported grad norm
is the pre-clip one (:682-685).
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch

BETAS = (0.9, 0.95)
SKIP_NAMES = ("pos_embed", "cls_token")


def decays(name: str, param: torch.Tensor, skip_names=SKIP_NAMES) -> bool:
    """Whether weight decay applies to the parameter ``name`` (a
    state_dict key of the reference schema)."""
    parts = name.split(".")
    if param.ndim <= 1 or parts[-1] == "bias":
        return False
    return not any(p in skip_names for p in parts)


def get_num_layer_for_vit(name: str, num_max_layer: int) -> int:
    """The layer id of the parameter ``name`` (a state_dict key of the
    reference schema, e.g. ``backbone.blocks.3.attn.qkv.weight``), the rules
    of optim.py:36-52 on the port's names. A per-block table is named
    ``relative_position_bias_table`` under its block and takes the block's
    id; only the shared ``rel_pos_bias`` module takes the last one."""
    parts = name.split(".")
    if any(p in ("cls_token", "mask_token", "pos_embed") for p in parts):
        return 0
    if "patch_embed" in parts:
        return 0
    if "rel_pos_bias" in parts:
        return num_max_layer - 1
    for a, b in zip(parts, parts[1:]):
        if a == "blocks" and b.isdigit():
            return int(b) + 1
    return num_max_layer - 1


def layer_decay_values(layer_decay: float, num_layers: int) -> list:
    """scale[i] = decay ** (num_layers + 1 - i) for i in 0..num_layers + 1
    (optim.py:55-59)."""
    n = num_layers + 2
    return [layer_decay ** (n - 1 - i) for i in range(n)]


def lr_scale(name: str, layer_decay: Optional[float], num_layers: int) -> float:
    """``build_lr_scale_tree`` (optim.py:74-83) for one parameter: 1.0 when
    layer decay is off."""
    if layer_decay is None or layer_decay >= 1.0 - 1e-12:
        return 1.0
    values = layer_decay_values(layer_decay, num_layers)
    return values[get_num_layer_for_vit(name, len(values))]


def create_optimizer(model: torch.nn.Module, lr: float, weight_decay: float,
                     opt: str = "adamw", opt_eps: float = 1e-8,
                     skip_names=SKIP_NAMES, layer_decay: Optional[float] = None,
                     num_layers: int = 0, betas=BETAS,
                     freeze_backbone: bool = False) -> torch.optim.AdamW:
    """AdamW over the model's trainable parameters, one group per (lr scale,
    decays) in the order the parameters first meet them: without layer decay
    group 0 decays and group 1 does not. Each group carries its ``lr_scale``
    and ``decays`` for :func:`set_schedule`. ``freeze_backbone`` is the
    reference's linear probe (run_class_finetuning.py:418-436): lr scale 1
    on ``head.*``, 0 on everything else (no layer decay, the default decay
    split), so only the head moves."""
    if opt.lower() != "adamw":
        raise NotImplementedError(
            f"--opt {opt}: only adamw is ported; the reference's other optimizers "
            f"(optim.py:497-679: sgd, momentum, nadam, adamp, lookahead) are ROADMAP "
            f"queue 1, item 8b")
    groups = {(1.0, True): [], (1.0, False): []}
    for name, p in model.named_parameters():
        if p.requires_grad:
            if freeze_backbone:
                key = (1.0 if name.split(".")[0] == "head" else 0.0, decays(name, p))
            else:
                key = (lr_scale(name, layer_decay, num_layers), decays(name, p, skip_names))
            groups.setdefault(key, []).append(p)
    return torch.optim.AdamW(
        [{"params": ps, "weight_decay": weight_decay if dec else 0.0, "lr": lr * scale,
          "lr_scale": scale, "decays": dec} for (scale, dec), ps in groups.items()],
        lr=lr, betas=tuple(betas), eps=opt_eps)


def set_schedule(optimizer: torch.optim.Optimizer, lr: float, wd: float) -> None:
    """Write this step's lr * scale into every group and wd into the
    decaying ones."""
    for g in optimizer.param_groups:
        g["lr"] = lr * g["lr_scale"]
        if g["decays"]:
            g["weight_decay"] = wd


def clip_grad_global_norm(params: Iterable[torch.Tensor],
                          clip: Optional[float]) -> torch.Tensor:
    """The pre-clip global gradient norm (0-d f32 tensor on the grads'
    device); with ``clip > 0`` the grads are scaled in place by
    min(1, clip / (norm + 1e-6)). No host synchronisation."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    if clip is not None and clip > 0:
        factor = torch.clamp(clip / (norm + 1e-6), max=1.0)
        torch._foreach_mul_(grads, factor)
    return norm
