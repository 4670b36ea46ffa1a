"""ViT building blocks, port of mem_tpu/models/vit.py.

flax ``dtype`` semantics are kept: parameters stay f32, each layer casts
them to the compute dtype (bf16 for serving and training) at use, LayerNorm
statistics and softmax run in f32. Submodules and parameters are named
after the reference's torch schema (mem_tpu/utils/torch_import.py:122-173),
so a state_dict from ``export_vit_params`` / ``from_jax_params`` loads with
``strict=True``.

Attention takes the reference's branches by the reference's rule
(vit.py:364-380), as its accelerator evaluates it: a fused kernel when the
module is ``fused``, without attention dropout, at head dims that are a
multiple of 8 and 8 <= N <= 1056, and when ``ops.attention.ENABLED`` is set,
N >= 512 or the (H, N, N) bias is head-blocked-eligible; the einsum path
otherwise (vit.py:505-557). On the CPU the port takes the branch the card
takes (the reference's CPU skips its kernels below N = 512 to spare
interpret mode), and the kernels take their plain versions. The fused
branch is flat -- ``fused_attention_flat`` (K2f/K2b on the card) for short
sequences, ``fused_attention_flat_long`` (K3f/K3b) for long ones, split by
``ops.attention.attention_route`` -- when ``FLAT_ATTN`` is set and the shape
is head-blocked-eligible or ``FLAT_ATTN_LONG`` is set, and head-major
otherwise. Three of the reference's module toggles are kept, with its names
and defaults, as module globals read at call time (the reference has no
flag for them either; scripts/trace_pretrain.py sets them the same way):

- ``FLAT_ATTN = False`` projects q, k, v straight into (B, H, N, D) and
  calls ``ops.attention.fused_attention`` (K5a/K5c, or K5b and K5d/K5e
  where the bias is not head-blocked-eligible), with the output projection
  contracting (head, head_dim) as the reference's ``_ProjOut`` does
  (vit.py:461-487);
- ``FLAT_ATTN_LONG = False`` sends the shapes that are not
  head-blocked-eligible (the segmentation backbone's 1025 tokens) to that
  head-major path too (vit.py:47-50, 379-380);
- ``FUSED_MLP = True`` sends every dropout-free ``Mlp`` through
  ``ops.mlp.mlp_fused`` (K6f/K6b) (vit.py:269-270).

``ops.attention.ENABLED`` is the reference's fourth switch (attention.py:39),
read there. In training mode (``module.train()``) the attention / proj / MLP
dropout and the per-sample drop-path of the reference run; their random bits come from an explicit
``torch.Generator`` on the activations' device that the caller passes to
``forward`` (the train step seeds one per step from (seed, step)), never
from torch's global generator.

``INT8_GEMM = True`` is the reference's W8A8 serving switch (vit.py:86),
honoured only in eval mode (``not module.training``, where the reference
checks ``deterministic``): fc1, the q / k / v projections and proj run
through ``ops.quant`` (per-output-column int8 weights, per-row dynamic int8
activations, int32 accumulation) on the flat and the einsum routes; fc2
stays in the compute dtype, ``FUSED_MLP`` keeps precedence, and the
head-major route (K5) has no int8 branch, as in the reference. The
reference's XLA scheduling toggles are not ported.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mem_tpu_torch.ops import attention as _fa
from mem_tpu_torch.ops.attention import (attention_route, fused_attention,
                                         fused_attention_flat, fused_attention_flat_long)
from mem_tpu_torch.ops.mlp import mlp_fused
from mem_tpu_torch.ops.quant import dense_w8a8, dense_w8a8_prequant, quantize_activation

# The reference's toggles (mem_tpu/models/vit.py:50, :57, :71), read at call time.
FLAT_ATTN_LONG = True  # False: shapes not head-blocked-eligible as with FLAT_ATTN = False
FLAT_ATTN = True       # False: q/k/v as (B, H, N, D) and kernels K5a-K5e
FUSED_MLP = False      # True: dropout-free MLPs through kernels K6f/K6b
INT8_GEMM = False      # True: W8A8 fc1 / qkv / proj in eval-mode forwards (vit.py:86)


@contextlib.contextmanager
def int8_gemm(enabled: bool = True):
    """``INT8_GEMM`` set inside the block when ``enabled`` (a CLI's ``--int8
    1``, where the reference sets the module flag for the process) and
    restored after it; with ``enabled`` false the flag is left alone."""
    global INT8_GEMM
    if not enabled:
        yield
        return
    old, INT8_GEMM = INT8_GEMM, True
    try:
        yield
    finally:
        INT8_GEMM = old


def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator,
                  trunc_sigmas: float = 2.0) -> torch.Tensor:
    """In-place truncated normal N(0, std^2) cut at +-trunc_sigmas std
    (inverse-CDF sampling from ``generator``)."""
    lo = 0.5 * (1.0 + math.erf(-trunc_sigmas / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(trunc_sigmas / math.sqrt(2.0)))
    with torch.no_grad():
        u = torch.rand(t.shape, generator=generator, device=generator.device)
        u = (lo + (hi - lo) * u) * 2.0 - 1.0
        x = torch.erfinv(u.clamp(-1 + 1e-7, 1 - 1e-7)) * (std * math.sqrt(2.0))
        t.copy_(x.clamp(-trunc_sigmas * std, trunc_sigmas * std))
    return t


def dropout(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale the kept
    values by 1 / (1 - rate), in x's dtype."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def drop_path(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """Stochastic depth, timm semantics (vit.py:133-141): one Bernoulli per
    sample, the kept samples rescaled by 1 / (1 - rate)."""
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def drop_path_rates(rate: float, depth: int) -> list:
    """The linear stochastic-depth schedule rate * i / max(depth - 1, 1)
    (vit.py:701)."""
    return [rate * i / max(depth - 1, 1) for i in range(depth)]


def _need_generator(generator, what: str):
    if generator is None:
        raise ValueError(f"{what} in training mode needs an explicit torch.Generator "
                         f"(forward(..., generator=g))")
    return generator


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax Dense(dtype=...): x @ W + b with W and b cast to the compute
    dtype, the bias added after the product is rounded."""
    y = torch.matmul(x.to(dtype), layer.weight.to(dtype).t())
    if layer.bias is not None:
        y = y + layer.bias.to(dtype)
    return y


class FusedLayerNorm(nn.Module):
    """LayerNorm with f32 two-pass statistics (mean, then mean of squared
    deviations), eps 1e-6, output in the input dtype (vit.py:97-117)."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        xf = x.float()
        m = xf.mean(dim=-1, keepdim=True)
        d = xf - m
        v = (d * d).mean(dim=-1, keepdim=True)
        y = d * torch.rsqrt(v + self.eps) * self.weight + self.bias
        return y.to(x.dtype)


class FastVarLayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=1e-6, dtype=float32)``: flax's default
    fast variance E[x^2] - E[x]^2 (clipped at 0), statistics and output in
    f32, scale folded into rsqrt before the multiply, as flax orders it."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        mean2 = (xf * xf).mean(dim=-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (xf - mean) * mul + self.bias


def relative_position_index(window_size) -> np.ndarray:
    """BEiT relative-position index for a (Wh, Ww) patch grid plus the cls
    token: (Wh*Ww+1, Wh*Ww+1) int32 into a table of (2Wh-1)(2Ww-1)+3 rows,
    the last three being cls->token, token->cls and cls->cls
    (vit.py:144-165)."""
    wh, ww = window_size
    num_rel = (2 * wh - 1) * (2 * ww - 1) + 3
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    idx = np.zeros((wh * ww + 1, wh * ww + 1), dtype=np.int32)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num_rel - 3
    idx[0:, 0] = num_rel - 2
    idx[0, 0] = num_rel - 1
    return idx


def gather_relative_position_bias(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """(num_rel, H) table gathered by the (N, N) index -> (H, N, N) f32."""
    n = index.shape[0]
    return table[index.reshape(-1)].reshape(n, n, -1).permute(2, 0, 1).float()


class RelativePositionBias(nn.Module):
    """The shared relative-position bias (one table for all blocks),
    expanded by a gather (vit.py:168-200). Returns (H, N+1, N+1)."""

    def __init__(self, window_size, num_heads: int, device=None):
        super().__init__()
        wh, ww = window_size
        num_rel = (2 * wh - 1) * (2 * ww - 1) + 3
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(num_rel, num_heads, device=device))
        self.register_buffer(
            "relative_position_index",
            torch.as_tensor(relative_position_index(window_size), dtype=torch.long,
                            device=device), persistent=False)

    def forward(self):
        return gather_relative_position_bias(self.relative_position_bias_table,
                                             self.relative_position_index)


class Mlp(nn.Module):
    """fc1 -> exact gelu -> fc2 in the compute dtype, then dropout (training
    only), as the reference orders them (vit.py:286-291); with ``FUSED_MLP``
    and no dropout, the fused kernel (vit.py:269-270); else with
    ``INT8_GEMM`` in eval mode, fc1 as a W8A8 product with its bias inside
    and fc2 in the compute dtype (vit.py:272-284)."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.fc1 = nn.Linear(dim, hidden_dim, device=device)
        self.fc2 = nn.Linear(hidden_dim, dim, device=device)

    def forward(self, x, generator=None):
        if FUSED_MLP and self.dropout == 0.0:
            return mlp_fused(x.to(self.dtype), self.fc1.weight.t(), self.fc1.bias,
                             self.fc2.weight.t(), self.fc2.bias)
        if INT8_GEMM and not self.training:
            # fc2 stays in the compute dtype: its input is the 4C-wide gelu
            # output, whose quantize pass costs what the int8 product saves
            h = dense_w8a8(x, self.fc1.weight.t(), self.fc1.bias, out_dtype=self.dtype)
            return linear(F.gelu(h, approximate="none"), self.fc2, self.dtype)
        x = F.gelu(linear(x, self.fc1, self.dtype), approximate="none")
        x = linear(x, self.fc2, self.dtype)
        if self.training and self.dropout > 0:
            x = dropout(x, self.dropout, _need_generator(generator, "Mlp dropout"))
        return x


class Attention(nn.Module):
    """Multi-head attention with BEiT's decomposed qkv bias (q and v learn a
    bias, k's is fixed zero) and an optional per-block relative-position
    bias. Three paths, as the reference (vit.py:364-557): flat (three
    products against slices of the fused qkv weight, then kernel K2, or K3 at
    long N, on (B, N, H*D)), head-major (products straight into (B, H, N,
    D), kernel K5) and plain einsums; the module docstring has the rule.
    ``fused=False`` keeps the module on the einsum path, as the reference's
    argument of that name."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 qk_scale: float | None = None, window_size=None,
                 attn_head_dim: int | None = None, proj_dropout: float = 0.0,
                 attn_dropout: float = 0.0, dtype=torch.float32, device=None,
                 fused: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.fused = fused
        self.proj_dropout = proj_dropout
        self.attn_dropout = attn_dropout
        self.dtype = dtype
        head_dim = attn_head_dim or dim // num_heads
        self.all_head_dim = head_dim * num_heads
        self.scale = float(qk_scale or head_dim ** -0.5)
        self.qkv = nn.Linear(dim, 3 * self.all_head_dim, bias=False, device=device)
        if qkv_bias:
            self.q_bias = nn.Parameter(torch.zeros(self.all_head_dim, device=device))
            self.v_bias = nn.Parameter(torch.zeros(self.all_head_dim, device=device))
        else:
            self.q_bias = self.v_bias = None
        if window_size is not None:
            wh, ww = window_size
            num_rel = (2 * wh - 1) * (2 * ww - 1) + 3
            self.relative_position_bias_table = nn.Parameter(
                torch.zeros(num_rel, num_heads, device=device))
            self.register_buffer(
                "relative_position_index",
                torch.as_tensor(relative_position_index(window_size), dtype=torch.long,
                                device=device), persistent=False)
        else:
            self.relative_position_bias_table = None
        self.proj = nn.Linear(self.all_head_dim, dim, device=device)

    def _bias(self, rel_pos_bias):
        bias = None
        if self.relative_position_bias_table is not None:
            bias = gather_relative_position_bias(self.relative_position_bias_table,
                                                 self.relative_position_index)
        if rel_pos_bias is not None:
            bias = rel_pos_bias if bias is None else bias + rel_pos_bias
        return bias

    def _qkv_flat(self, x):
        a = self.all_head_dim
        if INT8_GEMM and not self.training:
            # the activation quantized once for q, k and v (vit.py:383-395,
            # 492-503). One int8 product over the whole (C, 3C) weight: the
            # weight scales are per output column, so its int32
            # accumulators and outputs are the three slices' exactly
            xq, rs = quantize_activation(x)
            q, k, v = dense_w8a8_prequant(xq, rs, self.qkv.weight.t(), None,
                                          self.dtype).split(a, dim=-1)
        else:
            w = self.qkv.weight.to(self.dtype)
            q = torch.matmul(x, w[:a].t())
            k = torch.matmul(x, w[a:2 * a].t())
            v = torch.matmul(x, w[2 * a:].t())
        if self.q_bias is not None:
            q = q + self.q_bias.to(self.dtype)
            v = v + self.v_bias.to(self.dtype)
        return q, k, v

    def _proj(self, out):
        """The output projection of the flat and einsum routes: W8A8 with the
        bias inside under ``INT8_GEMM`` in eval mode (vit.py:441-447,
        537-545), else in the compute dtype."""
        if INT8_GEMM and not self.training:
            return dense_w8a8(out, self.proj.weight.t(), self.proj.bias, out_dtype=self.dtype)
        return linear(out, self.proj, self.dtype)

    def _forward_bhnd(self, x, bias):
        """vit.py:461-487: the head split rides the three products' outputs,
        K5a/K5c on (B, H, N, D), and the output projection contracts (head,
        head_dim) against the same ``proj`` parameters. No int8 branch: the
        reference has none on this route."""
        H, D = self.num_heads, self.all_head_dim // self.num_heads
        w3 = self.qkv.weight.to(self.dtype).reshape(3, H, D, -1)
        q, k, v = (torch.einsum("bnc,hdc->bhnd", x, w3[i]) for i in range(3))
        if self.q_bias is not None:
            q = q + self.q_bias.to(self.dtype).reshape(1, H, 1, D)
            v = v + self.v_bias.to(self.dtype).reshape(1, H, 1, D)
        out = fused_attention(q.contiguous(), k.contiguous(), v.contiguous(), bias,
                              self.scale)
        wp = self.proj.weight.to(self.dtype).reshape(-1, H, D)
        return torch.einsum("bhnd,ohd->bno", out, wp) + self.proj.bias.to(self.dtype)

    def _forward_einsum(self, x, bias, generator):
        """vit.py:505-557, the path the reference takes off its kernels
        (attention dropout, a head dim that is no multiple of 8, N < 8 or
        N > 1056, ``fused=False``): f32 scores from q * scale rounded in the
        compute dtype and k, + bias, f32 softmax, dropout, probabilities in the
        compute dtype times v."""
        B, N, _ = x.shape
        H = self.num_heads
        q, k, v = (t.reshape(B, N, H, -1) for t in self._qkv_flat(x))
        attn = torch.einsum("bnhd,bmhd->bhnm", (q * self.scale).float(), k.float())
        if bias is not None:
            attn = attn + bias
        attn = torch.softmax(attn, dim=-1)
        if self.training and self.attn_dropout > 0:
            attn = dropout(attn, self.attn_dropout,
                           _need_generator(generator, "attention dropout"))
        out = torch.einsum("bhnm,bmhd->bnhd", attn.to(self.dtype), v)
        return self._proj(out.reshape(B, N, self.all_head_dim))

    def use_fused(self, N: int) -> bool:
        """The reference's ``use_fused`` (vit.py:364-377) with its
        accelerator's answer for ``_hb_eligible`` shapes (``is_cpu`` false)."""
        H = self.num_heads
        return (self.fused and (_fa.ENABLED or N >= 512 or _fa._hb_eligible(H, N))
                and self.attn_dropout == 0.0 and (self.all_head_dim // H) % 8 == 0
                and 8 <= N <= 1056)

    def forward(self, x, rel_pos_bias=None, generator=None):
        N = x.shape[1]
        bias = self._bias(rel_pos_bias)
        if not self.use_fused(N):
            out = self._forward_einsum(x, None if bias is None else bias.float(), generator)
        else:
            if bias is None:
                bias = torch.zeros(self.num_heads, N, N, device=x.device)
            bias = bias.float().contiguous()
            if FLAT_ATTN and (_fa._hb_eligible(self.num_heads, N) or FLAT_ATTN_LONG):
                attend = (fused_attention_flat if attention_route(N) == "flat"
                          else fused_attention_flat_long)
                q, k, v = self._qkv_flat(x)
                out = attend(q.contiguous(), k.contiguous(), v.contiguous(), bias, self.scale)
                out = self._proj(out)
            else:
                out = self._forward_bhnd(x, bias)
        if self.training and self.proj_dropout > 0:
            out = dropout(out, self.proj_dropout,
                          _need_generator(generator, "Attention proj dropout"))
        return out


class Block(nn.Module):
    """Pre-norm transformer block with LayerScale and drop-path
    (vit.py:560-642)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: float | None = None,
                 init_values: float | None = None, window_size=None,
                 attn_head_dim: int | None = None, dropout: float = 0.0,
                 attn_dropout: float = 0.0, drop_path_rate: float = 0.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.drop_path_rate = drop_path_rate
        self.norm1 = FusedLayerNorm(dim, device=device)
        self.attn = Attention(dim, num_heads, qkv_bias=qkv_bias, qk_scale=qk_scale,
                              window_size=window_size, attn_head_dim=attn_head_dim,
                              proj_dropout=dropout, attn_dropout=attn_dropout,
                              dtype=dtype, device=device)
        self.norm2 = FusedLayerNorm(dim, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dropout=dropout, dtype=dtype, device=device)
        if init_values is not None and init_values > 0:
            self.gamma_1 = nn.Parameter(torch.full((dim,), float(init_values), device=device))
            self.gamma_2 = nn.Parameter(torch.full((dim,), float(init_values), device=device))
        else:
            self.gamma_1 = self.gamma_2 = None

    def _drop(self, y, generator):
        if self.training and self.drop_path_rate > 0:
            return drop_path(y, self.drop_path_rate, _need_generator(generator, "drop_path"))
        return y

    def forward(self, x, rel_pos_bias=None, generator=None):
        a = self.attn(self.norm1(x).to(self.dtype), rel_pos_bias, generator)
        if self.gamma_1 is not None:
            a = self.gamma_1.to(a.dtype) * a
        x = x + self._drop(a, generator)
        m = self.mlp(self.norm2(x).to(self.dtype), generator)
        if self.gamma_2 is not None:
            m = self.gamma_2.to(m.dtype) * m
        return x + self._drop(m, generator)


def conv_patches(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """A stride-P, kernel-P ``conv`` applied to NHWC images as one product:
    (B, H, W, C) -> (B, Hp*Wp, D), flax ``nn.Conv(padding="VALID",
    dtype=dtype)``. The (D, C, P, P) torch-layout weight is flattened in
    flax's (kh, kw, C) order, which is how the patches are laid out, so no
    convolution (and no cuDNN TF32 default) is involved."""
    B, H, W, C = x.shape
    ph, pw = conv.kernel_size
    hp, wp = H // ph, W // pw
    x = x[:, : hp * ph, : wp * pw].to(dtype)      # VALID padding
    patches = x.reshape(B, hp, ph, wp, pw, C).permute(0, 1, 3, 2, 4, 5)
    patches = patches.reshape(B, hp * wp, ph * pw * C)
    w = conv.weight.to(dtype).permute(2, 3, 1, 0).reshape(ph * pw * C, -1)
    return torch.matmul(patches, w) + conv.bias.to(dtype)


class PatchEmbed(nn.Module):
    """Stride-P patchify of NHWC images as one product (:func:`conv_patches`):
    (B, H, W, C) -> (B, Hp*Wp, D)."""

    def __init__(self, patch_size, in_chans: int, embed_dim: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.dtype = dtype
        self.proj = nn.Conv2d(in_chans, embed_dim, self.patch_size,
                              stride=self.patch_size, device=device)

    def forward(self, x):
        return conv_patches(x, self.proj, self.dtype)


class VitEncoder(nn.Module):
    """The transformer trunk (vit.py:670-721): blocks with an optional
    shared rel-pos bias. Its parameters sit at the top of the reference
    schema (``blocks.N.*``, ``rel_pos_bias.*``), so models that own a trunk
    subclass this module rather than hold it."""

    def __init__(self, embed_dim: int, depth: int, num_heads: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: float | None = None, init_values: float | None = None,
                 use_rel_pos_bias: bool = False, use_shared_rel_pos_bias: bool = False,
                 window_size=None, dropout: float = 0.0, attn_dropout: float = 0.0,
                 drop_path_rate: float = 0.0, dtype=torch.float32, device=None):
        super().__init__()
        self.rel_pos_bias = (RelativePositionBias(window_size, num_heads, device=device)
                             if use_shared_rel_pos_bias else None)
        self.blocks = nn.ModuleList([
            Block(embed_dim, num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                  qk_scale=qk_scale, init_values=init_values,
                  window_size=window_size if use_rel_pos_bias else None,
                  dropout=dropout, attn_dropout=attn_dropout, drop_path_rate=dpr,
                  dtype=dtype, device=device)
            for dpr in drop_path_rates(drop_path_rate, depth)])

    def encode(self, x, generator=None, return_all: bool = False):
        """The token sequence after the last block, or with ``return_all``
        the list of sequences after every block (the seg backbone's taps)."""
        rel_pos_bias = self.rel_pos_bias() if self.rel_pos_bias is not None else None
        feats = []
        for blk in self.blocks:
            x = blk(x, rel_pos_bias, generator)
            if return_all:
                feats.append(x)
        return feats if return_all else x

    def init_weights(self, generator: torch.Generator, init_std: float = 0.02,
                     trunc_sigmas: float = 2.0) -> None:
        """timm/BEiT init (vit.py trunc_normal_init): truncated normal at
        +-trunc_sigmas std for the products (2 for the classifier, 1 for
        the pretrain model, pretrain.py:69), zero biases, and the depth
        rescale 1/sqrt(2 * layer_id) on attn.proj and mlp.fc2."""
        for i, blk in enumerate(self.blocks):
            s = 1.0 / math.sqrt(2.0 * (i + 1))
            trunc_normal_(blk.attn.qkv.weight, init_std, generator, trunc_sigmas)
            trunc_normal_(blk.attn.proj.weight, init_std * s, generator, trunc_sigmas)
            trunc_normal_(blk.mlp.fc1.weight, init_std, generator, trunc_sigmas)
            trunc_normal_(blk.mlp.fc2.weight, init_std * s, generator, trunc_sigmas)
            for lin in (blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
                nn.init.zeros_(lin.bias)
