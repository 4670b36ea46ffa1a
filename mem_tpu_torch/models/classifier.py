"""ViT classifier (``ft_vit``), port of mem_tpu/models/classifier.py (the
reference's mem/modeling_finetune.py:250-385).

Mean-pool over patch tokens + ``fc_norm`` (default) or the cls token after
``norm``; an optional affine-free BatchNorm for linear probes; an f32 linear
head. In training mode (``module.train()``) the token dropout after the
embedding and the trunk's dropout / drop-path run, from the generator the
caller passes to ``forward``. Parameter names follow the reference torch
schema, so ``load_state_dict(strict=True)`` takes an ``export_vit_params``
state_dict as it is.
"""
from __future__ import annotations

import torch
from torch import nn

from mem_tpu_torch.models.vit import (FastVarLayerNorm, PatchEmbed, VitEncoder,
                                      _need_generator, dropout, trunc_normal_)


class ProbeBatchNorm(nn.Module):
    """The linear probe's affine-free BatchNorm (flax BatchNorm(use_bias=
    False, use_scale=False, momentum=0.9, epsilon=1e-5)). By default it
    normalises by the running statistics (``use_running_average``), which is
    also what the reference's finetune step does; with ``train_bn`` it
    normalises by the batch's mean and biased fast variance E[x^2] - E[x]^2
    and moves the running statistics towards them, as flax does."""

    def __init__(self, dim: int, eps: float = 1e-5, momentum: float = 0.9, device=None):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.register_buffer("running_mean", torch.zeros(dim, device=device))
        self.register_buffer("running_var", torch.ones(dim, device=device))

    def forward(self, x, train_bn: bool = False):
        if not train_bn:
            return (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        mean = x.mean(dim=0)
        var = torch.clamp((x * x).mean(dim=0) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
            self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        return (x - mean) * torch.rsqrt(var + self.eps)


class VisionTransformer(VitEncoder):
    def __init__(self, img_size=(224, 224), patch_size=(16, 16), in_chans: int = 3,
                 num_classes: int = 1000, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: float | None = None, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 init_values: float | None = 0.1, use_abs_pos_emb: bool = False, use_rel_pos_bias: bool = True,
                 use_shared_rel_pos_bias: bool = False, use_mean_pooling: bool = True,
                 init_scale: float = 0.001, use_batch_norm: bool = False,
                 dtype=torch.float32, device=None):
        patch_shape = (img_size[0] // patch_size[0], img_size[1] // patch_size[1])
        super().__init__(embed_dim, depth, num_heads, mlp_ratio=mlp_ratio,
                         qkv_bias=qkv_bias, qk_scale=qk_scale, init_values=init_values,
                         use_rel_pos_bias=use_rel_pos_bias,
                         use_shared_rel_pos_bias=use_shared_rel_pos_bias,
                         window_size=patch_shape, dropout=drop_rate,
                         attn_dropout=attn_drop_rate, drop_path_rate=drop_path_rate,
                         dtype=dtype, device=device)
        self.patch_shape = patch_shape
        self.drop_rate = drop_rate
        self.dtype = dtype
        self.init_scale = init_scale
        self.use_mean_pooling = use_mean_pooling
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim, dtype=dtype,
                                      device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim, device=device))
        n_tokens = patch_shape[0] * patch_shape[1] + 1
        self.pos_embed = (nn.Parameter(torch.zeros(1, n_tokens, embed_dim, device=device))
                          if use_abs_pos_emb else None)
        if use_mean_pooling:
            self.fc_norm = FastVarLayerNorm(embed_dim, device=device)
        else:
            self.norm = FastVarLayerNorm(embed_dim, device=device)
        self.batch_norm = ProbeBatchNorm(embed_dim, device=device) if use_batch_norm else None
        self.head = nn.Linear(embed_dim, num_classes, device=device) if num_classes > 0 else None

    def init_weights(self, generator: torch.Generator, init_std: float = 0.02) -> None:
        """Seeded init mirroring the flax initializers (classifier.py)."""
        super().init_weights(generator, init_std)
        trunc_normal_(self.patch_embed.proj.weight, init_std, generator)
        nn.init.zeros_(self.patch_embed.proj.bias)
        trunc_normal_(self.cls_token, init_std, generator)
        if self.pos_embed is not None:
            trunc_normal_(self.pos_embed, init_std, generator)
        if self.head is not None:
            trunc_normal_(self.head.weight, init_std, generator)
            with torch.no_grad():
                self.head.weight.mul_(self.init_scale)
            nn.init.zeros_(self.head.bias)

    def forward(self, x, generator=None, train_bn: bool = False):
        """(B, H, W, C) NHWC images -> (B, num_classes) f32 logits.
        ``generator`` feeds dropout and drop-path in training mode;
        ``train_bn`` has the probe BatchNorm use and record batch statistics."""
        tokens = self.patch_embed(x)
        B, _, D = tokens.shape
        cls = self.cls_token.to(tokens.dtype).expand(B, 1, D)
        tokens = torch.cat([cls, tokens], dim=1)
        if self.pos_embed is not None:
            tokens = tokens + self.pos_embed.to(tokens.dtype)
        if self.training and self.drop_rate > 0:
            tokens = dropout(tokens, self.drop_rate,
                             _need_generator(generator, "token dropout"))
        tokens = self.encode(tokens, generator)
        if self.use_mean_pooling:
            # jnp.mean of bf16 accumulates in f32 and returns bf16
            feat = self.fc_norm(tokens[:, 1:].float().mean(dim=1).to(tokens.dtype))
        else:
            feat = self.norm(tokens)[:, 0]
        if self.batch_norm is not None:
            feat = self.batch_norm(feat, train_bn)
        if self.head is None:
            return feat
        return torch.matmul(feat.float(), self.head.weight.t()) + self.head.bias
