"""BEiT-style masked-image-modeling ViT (``pt_vit``) and its loss, port of
mem_tpu/models/pretrain.py (the reference's mem/modeling_pretrain.py:22-140).

NHWC images in; the patch tokens at masked positions are blended with a
learned mask token, the cls token is prepended, the encoder runs (with
drop-path and dropout in training mode), the final ``norm`` is flax's
fast-variance LayerNorm in f32, and the 8192-way ``lm_head`` runs in the
compute dtype. With ``num_masked_tokens`` set (the pretraining CLI sets it
to ``--num_mask_patches``) the head runs only on a static gather of the
first ``num_masked_tokens`` positions of a stable argsort that puts the
masked positions first (pretrain.py:119-127), and the model returns
(logits (B, M, V), idx (B, M)). Parameter names follow the reference torch
schema (``export_vit_params``), so checkpoints load with ``strict=True``.
"""
from __future__ import annotations

import torch
from torch import nn

from mem_tpu_torch.models.vit import (FastVarLayerNorm, PatchEmbed, VitEncoder, _need_generator,
                                      dropout, linear, trunc_normal_)

PRETRAIN_TRUNC_SIGMAS = 1.0   # the reference pretrain init truncates at +-1 std


class VisionTransformerForMaskedImageModeling(VitEncoder):
    def __init__(self, img_size=(224, 224), patch_size=(16, 16), in_chans: int = 3,
                 vocab_size: int = 8192, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: float | None = None, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 init_values: float | None = 0.1, use_abs_pos_emb: bool = False,
                 use_rel_pos_bias: bool = False, use_shared_rel_pos_bias: bool = True,
                 init_std: float = 0.02, num_masked_tokens: int | None = None,
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
        self.dtype = dtype
        self.drop_rate = drop_rate
        self.init_std = init_std
        self.num_masked_tokens = num_masked_tokens
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim, dtype=dtype,
                                      device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim, device=device))
        self.mask_token = nn.Parameter(torch.zeros(1, 1, embed_dim, device=device))
        n_tokens = patch_shape[0] * patch_shape[1] + 1
        self.pos_embed = (nn.Parameter(torch.zeros(1, n_tokens, embed_dim, device=device))
                          if use_abs_pos_emb else None)
        self.norm = FastVarLayerNorm(embed_dim, device=device)
        self.lm_head = nn.Linear(embed_dim, vocab_size, device=device)

    def init_weights(self, generator: torch.Generator, init_std: float | None = None) -> None:
        """Seeded init mirroring the flax initializers: truncated normal at
        +-1 std everywhere (pretrain.py:69), zero biases, the depth rescale
        on attn.proj and mlp.fc2, LayerNorms at (1, 0), LayerScale at
        init_values."""
        std = self.init_std if init_std is None else init_std
        ts = PRETRAIN_TRUNC_SIGMAS
        super().init_weights(generator, std, ts)
        trunc_normal_(self.patch_embed.proj.weight, std, generator, ts)
        nn.init.zeros_(self.patch_embed.proj.bias)
        trunc_normal_(self.cls_token, std, generator, ts)
        trunc_normal_(self.mask_token, std, generator, ts)
        if self.pos_embed is not None:
            trunc_normal_(self.pos_embed, std, generator, ts)
        trunc_normal_(self.lm_head.weight, std, generator, ts)
        nn.init.zeros_(self.lm_head.bias)

    def forward(self, x, bool_masked_pos, generator=None):
        """x (B, H, W, C) NHWC images, bool_masked_pos (B, N) bool ->
        logits (B, N, vocab) in the compute dtype, or (logits (B, M, vocab),
        idx (B, M)) when ``num_masked_tokens`` is set. ``generator`` feeds
        the dropout / drop-path draws in training mode."""
        tokens = self.patch_embed(x.to(self.dtype))
        B, N, D = tokens.shape
        w = bool_masked_pos[..., None].to(tokens.dtype)
        tokens = tokens * (1 - w) + self.mask_token.to(tokens.dtype) * w
        cls = self.cls_token.to(tokens.dtype).expand(B, 1, D)
        tokens = torch.cat([cls, tokens], dim=1)
        if self.pos_embed is not None:
            tokens = tokens + self.pos_embed.to(tokens.dtype)
        if self.training and self.drop_rate > 0:
            tokens = dropout(tokens, self.drop_rate,
                             _need_generator(generator, "token dropout"))
        tokens = self.encode(tokens, generator)
        patch_tokens = self.norm(tokens)[:, 1:]
        idx = None
        if self.num_masked_tokens is not None:
            order = torch.argsort(torch.where(bool_masked_pos, 0, 1).to(torch.int32),
                                  dim=1, stable=True)
            idx = order[:, : self.num_masked_tokens]
            patch_tokens = torch.gather(patch_tokens, 1, idx[..., None].expand(-1, -1, D))
        logits = linear(patch_tokens, self.lm_head, self.dtype)
        return (logits, idx) if idx is not None else logits


def masked_cross_entropy(logits, labels, mask, group=None):
    """CE over the vocabulary at masked positions only, and the mlm
    accuracy (pretrain.py:141-160): ``logit[label] - logsumexp`` in f32.
    logits (B, N, V); labels (B, N) int; mask (B, N) bool. Returns
    (loss, acc) as 0-d f32 tensors. With ``group`` (the "data" processes) the
    masked positions are counted over the global batch (the block mask gives
    at least ``num_masking_patches`` a sample, so the ranks' counts differ;
    parallel/mesh.py ``global_quotient``)."""
    from mem_tpu_torch.parallel.mesh import global_quotient

    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    logp = tgt - lse
    m = mask.float()
    denom = torch.clamp(m.sum(), min=1.0)
    loss = global_quotient(-(logp * m).sum(), denom, group)
    correct = (torch.argmax(logits, dim=-1) == labels).float()
    acc = global_quotient((correct * m).sum(), denom, group)
    return loss, acc


def masked_cross_entropy_gathered(logits, idx, labels, mask, group=None):
    """The same objective for the gathered head (pretrain.py:163-170):
    logits (B, M, V) at positions ``idx`` (B, M); labels / mask (B, N)."""
    labels_g = torch.gather(labels, 1, idx)
    mask_g = torch.gather(mask, 1, idx)
    return masked_cross_entropy(logits, labels_g, mask_g, group)
