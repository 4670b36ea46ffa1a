"""The MAE-finetune classifier, port of mem_tpu/models/mae_classifier.py
(the reference's run_class_finetuning.py:43-82 ``VisionTransformer
(global_pool=True)`` + ``vit_base_patch16``).

timm's ViT: the patch conv, a cls token, a learned ``pos_embed`` parameter
initialised to the 2-D sin-cos grid (what an MAE encoder's saved buffer
writes into it; a non-square grid takes the square table's row-major
crop), token dropout, ``TimmBlock``s with timm's linspace drop-path, and
either the global-pool readout (mean over the patch tokens -> ``fc_norm``
in f32 -> head) or ``norm`` -> the cls token. The head is f32 with a
trunc_normal(2e-5) kernel, the reference's re-init after the checkpoint load.
Parameter names are ``export_mae_classifier_params``'s keys
(torch_import.py:214), which share the MAE encoder's, so
``utils.surgery.surgery_for_mae_finetune`` loads a pretraining checkpoint
key for key. In training mode dropout and drop-path draw from the
generator the caller passes to ``forward``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from mem_tpu_torch.models.mae import (TimmBlock, get_2d_sincos_pos_embed, init_timm_weights,
                                      normal_)
from mem_tpu_torch.models.vit import (FastVarLayerNorm, _need_generator, conv_patches,
                                      drop_path_rates, dropout, trunc_normal_)


def sincos_table(embed_dim: int, grid) -> np.ndarray:
    """(1, 1 + gh * gw, embed_dim) f32: the square table of max(gh, gw), its
    grid cropped row-major to (gh, gw) (mae_classifier.py:71-83)."""
    gh, gw = grid
    g = max(gh, gw)
    full = get_2d_sincos_pos_embed(embed_dim, g, cls_token=True)
    if (gh, gw) != (g, g):
        part = full[1:].reshape(g, g, embed_dim)[:gh, :gw].reshape(-1, embed_dim)
        full = np.concatenate([full[:1], part], axis=0)
    return full[None]


class MAEVisionTransformer(nn.Module):
    def __init__(self, img_size=(224, 224), patch_size: int = 16, in_chans: int = 3,
                 num_classes: int = 1000, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0, drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, global_pool: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.grid = (img_size[0] // patch_size, img_size[1] // patch_size)
        self.drop_rate = drop_rate
        self.global_pool = global_pool
        self.dtype = dtype
        self.patch_embed = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size,
                                     device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim, device=device))
        self.pos_embed = nn.Parameter(
            torch.from_numpy(sincos_table(embed_dim, self.grid)).to(device))
        self.blocks = nn.ModuleList([
            TimmBlock(embed_dim, num_heads, mlp_ratio, dtype, drop_path_rate=dpr,
                      device=device)
            for dpr in drop_path_rates(drop_path_rate, depth)])
        if global_pool:
            self.fc_norm = FastVarLayerNorm(embed_dim, device=device)
        else:
            self.norm = FastVarLayerNorm(embed_dim, device=device)
        self.head = nn.Linear(embed_dim, num_classes, device=device) if num_classes > 0 else None

    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded init with the reference's initializers: xavier-uniform
        kernels, zero biases, unit LayerNorms, normal(0.02) cls token, the
        sin-cos ``pos_embed``, the head trunc_normal(2e-5)."""
        init_timm_weights(self, generator)
        normal_(self.cls_token, 0.02, generator)
        with torch.no_grad():
            self.pos_embed.copy_(torch.from_numpy(sincos_table(self.pos_embed.shape[-1],
                                                               self.grid)))
        if self.head is not None:
            trunc_normal_(self.head.weight, 2e-5, generator)

    def forward(self, x, generator=None):
        """(B, H, W, C) NHWC images -> (B, num_classes) f32 logits (the
        pooled features when there is no head)."""
        x = conv_patches(x, self.patch_embed, self.dtype)
        B, _, D = x.shape
        x = torch.cat([self.cls_token.to(x.dtype).expand(B, 1, D), x], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        if self.training and self.drop_rate > 0:
            x = dropout(x, self.drop_rate, _need_generator(generator, "token dropout"))
        for blk in self.blocks:
            x = blk(x, generator)
        if self.global_pool:
            # jnp.mean of bf16 accumulates in f32 and returns bf16
            feat = self.fc_norm(x[:, 1:].float().mean(dim=1).to(x.dtype))
        else:
            feat = self.norm(x)[:, 0]
        if self.head is None:
            return feat
        return torch.matmul(feat.float(), self.head.weight.t()) + self.head.bias
