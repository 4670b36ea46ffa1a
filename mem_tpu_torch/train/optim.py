"""AdamW for pretraining, port of mem_tpu/train/optim.py
``create_optimizer(opt="adamw")`` / ``scheduled_adamw`` (:113-178).

``torch.optim.AdamW`` with two parameter groups, decay and no-decay, split
as ``build_wd_mask_tree`` (:86-100) splits the flax tree: no decay for 1-D
parameters, ``*bias`` and ``cls_token`` / ``pos_embed``; ``mask_token``
(3-D) and the 2-D relative-position table are decayed. Betas are hard-set
to (0.9, 0.95) (the reference's override, optim_factory.py:121). Each step
the caller writes lr[t] and wd[t] into the groups (:167-168) and clips by
global norm with factor clip / (norm + 1e-6) before the moments
(:152-155); the reported grad norm is the pre-clip one (:682-685).
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


def create_optimizer(model: torch.nn.Module, lr: float, weight_decay: float,
                     opt: str = "adamw", opt_eps: float = 1e-8,
                     skip_names=SKIP_NAMES) -> torch.optim.AdamW:
    """AdamW over the model's trainable parameters in two groups: group 0
    decays, group 1 does not."""
    if opt.lower() != "adamw":
        raise NotImplementedError(
            f"--opt {opt}: only adamw is ported; the reference's other optimizers "
            f"(optim.py:497-679) come with the classification-finetune slice of the "
            f"port (ROADMAP queue 1, item 8)")
    decay, no_decay = [], []
    for name, p in model.named_parameters():
        if p.requires_grad:
            (decay if decays(name, p, skip_names) else no_decay).append(p)
    groups = [{"params": decay, "weight_decay": weight_decay},
              {"params": no_decay, "weight_decay": 0.0}]
    return torch.optim.AdamW(groups, lr=lr, betas=BETAS, eps=opt_eps)


def set_schedule(optimizer: torch.optim.Optimizer, lr: float, wd: float) -> None:
    """Write this step's lr into both groups and wd into the decay group."""
    optimizer.param_groups[0]["lr"] = lr
    optimizer.param_groups[0]["weight_decay"] = wd
    optimizer.param_groups[1]["lr"] = lr


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
