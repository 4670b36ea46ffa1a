"""MAE pixel-regression pretraining model (``--MAE 1``), port of
mem_tpu/models/mae.py (the reference's modeling_mae.py:101-313).

Per-sample random shuffle masking (an argsort of uniform noise), an encoder
over the visible tokens only, a decoder that unshuffles mask tokens back
into place, fixed 2-D sin-cos position embeddings, and a pixel-MSE loss.
The blocks are timm's standard ViT block (fused qkv with a bias, no
LayerScale, no rel-pos bias).

flax ``dtype`` semantics are kept: parameters stay f32, each layer casts
them to the compute dtype at use, LayerNorm statistics and the loss run in
f32, ``decoder_pred`` runs in f32. Parameter names are the keys of
mem_tpu/utils/torch_import.py ``export_mae_params`` (:176), so its state_dict
loads with ``strict=True``; both sin-cos tables are non-persistent buffers.

The shuffle noise is (B, L) uniform f32, drawn from the ``torch.Generator``
the caller passes (the train step seeds one per step), or passed in as
``noise``; the reference draws it from its step's mask key
(train/steps.py:224-233), whose bits torch cannot reproduce.

Attention follows the reference's own rule for these blocks (mae.py:88): with
``FLAT_ATTN`` (a module global read at call time, default True) the flat
kernels, as the accelerator evaluates ``FLAT_ATTN and (ENABLED or N >= 512
or not is_cpu)``; otherwise the einsum path. The flat branch takes
``fused_attention_flat`` (K2f/K2b on the card) or, above FLAT_MAX_N tokens,
``fused_attention_flat_long`` (K3f/K3b), as ``ops.attention.attention_route``
says for every model of the port; the reference routes on ``_hb_eligible``
instead, which differs only between 257 and 330 tokens at 12 heads. The
bias is an all-zero (H, N, N) f32 tensor, as the reference's.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from mem_tpu_torch.models.vit import (FastVarLayerNorm, _need_generator, conv_patches,
                                      drop_path, linear)
from mem_tpu_torch.ops.attention import (attention_route, fused_attention_flat,
                                         fused_attention_flat_long)

MASK_RATIO = 0.5   # the reference's modeling_mae.py:19

# The reference's toggle (mem_tpu/models/mae.py:29), read at call time:
# False sends every block's attention down the einsum path.
FLAT_ATTN = True


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int, cls_token: bool = True) -> np.ndarray:
    """Fixed 2-D sin-cos position embedding, (grid_size^2 [+ 1], embed_dim)
    f32, computed in f64 (mae.py:32-50)."""

    def _1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000**omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_h = np.arange(grid_size, dtype=np.float64)
    grid_w = np.arange(grid_size, dtype=np.float64)
    grid = np.meshgrid(grid_w, grid_h)  # w goes first
    grid = np.stack(grid, axis=0).reshape(2, 1, grid_size, grid_size)
    emb_h = _1d(embed_dim // 2, grid[0])
    emb_w = _1d(embed_dim // 2, grid[1])
    pos = np.concatenate([emb_h, emb_w], axis=1)
    if cls_token:
        pos = np.concatenate([np.zeros((1, embed_dim)), pos], axis=0)
    return pos.astype(np.float32)


class TimmBlock(nn.Module):
    """timm's ViT block (mae.py:53-109): pre-norm LayerNorms (eps 1e-6, f32,
    then the compute dtype), a fused ``qkv`` Linear with a bias, exact erf
    gelu, and timm's drop-path on both residual branches in training mode,
    drawn from the generator the caller passes."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype=torch.float32, drop_path_rate: float = 0.0, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.drop_path_rate = drop_path_rate
        self.norm1 = FastVarLayerNorm(dim, device=device)
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)
        self.norm2 = FastVarLayerNorm(dim, device=device)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio), device=device)
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim, device=device)

    def attention(self, h: torch.Tensor) -> torch.Tensor:
        B, N, C = h.shape
        H = self.num_heads
        hd = C // H
        qkv = linear(h, self.qkv, self.dtype)
        if FLAT_ATTN:
            # the qkv columns are [q | k | v], each flat head-major (H * hd):
            # the layout the flat kernels read
            q, k, v = (t.contiguous() for t in qkv.split(C, dim=-1))
            bias = torch.zeros(H, N, N, device=h.device)
            attend = (fused_attention_flat if attention_route(N) == "flat"
                      else fused_attention_flat_long)
            o = attend(q, k, v, bias, float(hd ** -0.5))
        else:
            # mae.py:98-102: q scaled in the compute dtype, f32 scores and
            # softmax, the probabilities in the compute dtype times v
            q, k, v = qkv.reshape(B, N, 3, H, hd).unbind(2)
            attn = torch.einsum("bnhd,bmhd->bhnm", (q * hd ** -0.5).float(), k.float())
            attn = torch.softmax(attn, dim=-1).to(self.dtype)
            o = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(B, N, C)
        return linear(o, self.proj, self.dtype)

    def _drop(self, y, generator):
        if self.training and self.drop_path_rate > 0:
            return drop_path(y, self.drop_path_rate, _need_generator(generator, "drop_path"))
        return y

    def forward(self, x, generator=None):
        x = x + self._drop(self.attention(self.norm1(x).to(self.dtype)), generator)
        h = linear(self.norm2(x).to(self.dtype), self.fc1, self.dtype)
        h = torch.nn.functional.gelu(h, approximate="none")
        return x + self._drop(linear(h, self.fc2, self.dtype), generator)


def xavier_uniform_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """In-place U(-a, a), a = sqrt(6 / (fan_in + fan_out)) with the
    receptive field in both fans (flax's and torch's rule alike), drawn on
    the generator's device, so one seed gives one tensor on every device."""
    rf = math.prod(t.shape[2:])
    bound = math.sqrt(6.0 / ((t.shape[0] + t.shape[1]) * rf))
    with torch.no_grad():
        u = torch.rand(t.shape, generator=generator, device=generator.device)
        t.copy_((2.0 * u - 1.0) * bound)
    return t


def normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    """In-place N(0, std^2), drawn on the generator's device."""
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=generator, device=generator.device) * std)
    return t


def init_timm_weights(module: nn.Module, generator: torch.Generator) -> None:
    """flax's defaults as the reference's modules use them: xavier-uniform
    Linear and patch-conv kernels (flax's receptive-field fan-in / fan-out
    equal torch's), zero biases, LayerNorm scale 1 and bias 0."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            xavier_uniform_(m.weight, generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, FastVarLayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


class MaskedAutoencoderViT(nn.Module):
    """mae.py:112-220 on NHWC images: ``forward(imgs, noise=None,
    generator=None)`` -> (loss, reconstruction (B, H, W, C) f32, mask (B, L),
    1 where a patch was masked)."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, in_chans: int = 3,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 decoder_embed_dim: int = 512, decoder_depth: int = 8,
                 decoder_num_heads: int = 16, mlp_ratio: float = 4.0,
                 norm_pix_loss: bool = False, loss_only_masked: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.patch_size = patch_size
        self.in_chans = in_chans
        self.grid = img_size // patch_size
        self.norm_pix_loss = norm_pix_loss
        self.loss_only_masked = loss_only_masked
        self.dtype = dtype
        self.patch_embed = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size,
                                     device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim, device=device))
        self.blocks = nn.ModuleList([
            TimmBlock(embed_dim, num_heads, mlp_ratio, dtype, device=device)
            for _ in range(depth)])
        self.norm = FastVarLayerNorm(embed_dim, device=device)
        self.decoder_embed = nn.Linear(embed_dim, decoder_embed_dim, device=device)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, decoder_embed_dim, device=device))
        self.decoder_blocks = nn.ModuleList([
            TimmBlock(decoder_embed_dim, decoder_num_heads, mlp_ratio, dtype, device=device)
            for _ in range(decoder_depth)])
        self.decoder_norm = FastVarLayerNorm(decoder_embed_dim, device=device)
        self.decoder_pred = nn.Linear(decoder_embed_dim, patch_size ** 2 * in_chans,
                                      device=device)
        for name, dim in (("pos_embed", embed_dim), ("decoder_pos_embed", decoder_embed_dim)):
            table = get_2d_sincos_pos_embed(dim, self.grid)[None]
            self.register_buffer(name, torch.from_numpy(table).to(device), persistent=False)

    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded init with flax's initializers (mae.py): xavier-uniform
        kernels, zero biases, unit LayerNorms, normal(0.02) tokens."""
        init_timm_weights(self, generator)
        normal_(self.cls_token, 0.02, generator)
        normal_(self.mask_token, 0.02, generator)

    def patchify(self, imgs: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, L, p*p*C), channel-last within a patch (the
        reference's ``bhpwqc->bhwpqc``)."""
        p = self.patch_size
        B, H, W, C = imgs.shape
        x = imgs.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(B, (H // p) * (W // p), p * p * C)

    def unpatchify(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        B, L, _ = x.shape
        h = w = int(L ** 0.5)
        x = x.reshape(B, h, w, p, p, self.in_chans).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(B, h * p, w * p, self.in_chans)

    def random_masking(self, x, noise):
        """mae.py:170-180: keep the ``len_keep`` tokens of lowest noise;
        returns (kept tokens, mask, ids_restore)."""
        B, L, D = x.shape
        len_keep = int(L * (1 - MASK_RATIO))
        ids_shuffle = torch.argsort(noise, dim=1, stable=True)
        ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
        ids_keep = ids_shuffle[:, :len_keep]
        x = torch.gather(x, 1, ids_keep[..., None].expand(-1, -1, D))
        mask = torch.ones(B, L, device=x.device)
        mask[:, :len_keep] = 0
        return x, torch.gather(mask, 1, ids_restore), ids_restore

    def loss(self, imgs, pred, mask, group=None):
        """mae.py:208-219 in f32: the per-patch mean squared error, summed
        over batch and patches (no division by B), or with
        ``loss_only_masked`` averaged over the masked patches; with
        ``norm_pix_loss`` each target patch normalised by its mean and its
        population variance. With ``group`` (the "data" processes) the sum
        and the masked count are the global batch's (parallel/mesh.py)."""
        from mem_tpu_torch.parallel.mesh import global_quotient, global_scale

        target = self.patchify(imgs.float())
        if self.norm_pix_loss:
            mean = target.mean(dim=-1, keepdim=True)
            var = target.var(dim=-1, keepdim=True, correction=0)
            target = (target - mean) / (var + 1e-6) ** 0.5
        loss = ((pred - target) ** 2).mean(dim=-1)
        if self.loss_only_masked:
            return global_quotient((loss * mask).sum(), mask.sum(), group)
        return loss.sum() * global_scale(group)

    def forward(self, imgs, noise=None, generator=None, group=None):
        """``imgs`` (B, H, W, C); ``noise`` (B, L) f32 uniform, or drawn from
        ``generator`` (on the images' device) when None; ``group`` as in
        :meth:`loss`."""
        B = imgs.shape[0]
        L = self.grid * self.grid
        if noise is None:
            noise = torch.rand((B, L), generator=_need_generator(generator, "the MAE mask"),
                               device=imgs.device)

        # encoder over the visible tokens
        x = conv_patches(imgs, self.patch_embed, self.dtype)
        x = x + self.pos_embed[:, 1:].to(x.dtype)
        x, mask, ids_restore = self.random_masking(x, noise)
        cls = (self.cls_token + self.pos_embed[:, :1]).to(x.dtype)
        x = torch.cat([cls.expand(B, 1, -1), x], dim=1)
        for blk in self.blocks:
            x = blk(x, generator)
        x = self.norm(x)

        # decoder over every position, mask tokens unshuffled into place
        x = linear(x, self.decoder_embed, self.dtype)
        dd = x.shape[-1]
        mt = self.mask_token.to(x.dtype).expand(B, L + 1 - x.shape[1], dd)
        x_ = torch.cat([x[:, 1:], mt], dim=1)
        x_ = torch.gather(x_, 1, ids_restore[..., None].expand(-1, -1, dd))
        x = torch.cat([x[:, :1], x_], dim=1) + self.decoder_pos_embed.to(x.dtype)
        for blk in self.decoder_blocks:
            x = blk(x, generator)
        x = self.decoder_norm(x)
        pred = (torch.matmul(x.float(), self.decoder_pred.weight.t())
                + self.decoder_pred.bias)[:, 1:]
        return self.loss(imgs, pred, mask, group), self.unpatchify(pred), mask
