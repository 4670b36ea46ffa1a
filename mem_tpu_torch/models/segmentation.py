"""Semantic segmentation: EvBEiT backbone + UPerNet / FCN heads.

Port of mem_tpu/models/segmentation.py (the reference's mmsegmentation
stack, backbone/mem.py:277-452 + UPerHead / FCNHead):

  EvBEiT: resize the input to 512^2 -> ViT-B/16 with a per-block relative
  position bias over the 32x32 window and LayerScale -> tap blocks
  [8, 9, 10, 11] -> 4 FPN necks (x4 deconv+BN+GELU+deconv / x2 deconv /
  identity / maxpool2)
  UPerHead: PPM (adaptive pools 1/2/3/6 as averaging matrices) + lateral
  top-down FPN fusion -> 512-channel bottleneck -> classifier
  FCNHead: the auxiliary 1-conv head on tap 2.

At 512^2 the backbone's sequences are 1025 tokens long, so its attention
runs through kernels K3f and, backward, K3b (models/vit.py routes on the
length).

Public tensors are NHWC, as in the reference. A contiguous NHWC tensor
viewed as (B, C, H, W) is exactly PyTorch's channels_last layout, so the
convolutions run on permuted views and nothing is copied to change layout.
Dtypes follow the reference: convolutions in the compute dtype (bf16 for
serving), BatchNorm, the taps, the pooling and the resizes in f32
(segmentation.py:73, 141), the classifiers in f32.

``train=False`` (a module in ``eval()`` mode): BatchNorm uses its running
statistics and dropout and drop-path are off. ``train=True`` (a module in
``train()`` mode): BatchNorm normalises with the batch's statistics and
updates the running ones, the heads drop 10 % of their last feature map and
the backbone runs drop-path, all from the ``torch.Generator`` the caller
passes (the train step seeds one per step). The argument and the module's
mode must agree. One process holds the whole batch, so the batch statistics
are the reference's global ones (its "SyncBN", segmentation.py:15-17).
Parameter and buffer names are those ``export_seg_params`` writes (mem_tpu/utils/torch_import.py:453), so a
state_dict from ``utils.weights.seg_from_jax_params`` loads with
``strict=True``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mem_tpu_torch.models.discrete_vae import TorchConvTranspose, cudnn_full_f32
from mem_tpu_torch.models.vit import (PatchEmbed, VitEncoder, _need_generator, dropout,
                                      trunc_normal_)
from mem_tpu_torch.ops.consts import cached
from mem_tpu_torch.ops.image_ops import resize_bilinear


def adaptive_pool_matrix(out_size: int, in_size: int) -> np.ndarray:
    """(out, in) row-stochastic averaging matrix reproducing torch
    F.adaptive_avg_pool2d binning; pooled = Py @ x @ Px^T."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        a = math.floor(i * in_size / out_size)
        b = math.ceil((i + 1) * in_size / out_size)
        m[i, a:b] = 1.0 / (b - a)
    return m


def _upsample(x, h: int, w: int):
    """Bilinear align_corners=False resize of NHWC (mmseg resize semantics),
    f32 out."""
    return resize_bilinear(x, h, w)


def _check_mode(module: nn.Module, train: bool) -> None:
    """``train=`` picks batch or running statistics and the dropouts, the
    module's mode drives the trunk's drop-path: the two must agree."""
    if bool(train) != module.training:
        raise ValueError(
            f"{type(module).__name__}: train={bool(train)} but the module is in "
            f"{'train' if module.training else 'eval'}() mode; call "
            f".{'train' if train else 'eval'}() first")


def _conv_precision(dtype):
    """f32 convolutions run in full f32 on the card, not cuDNN's TF32
    default, as the reference's f32 does."""
    return cudnn_full_f32() if dtype == torch.float32 else contextlib.nullcontext()


def conv2d_nhwc(x, weight, bias, padding: int, dtype):
    """``flax.linen.Conv(dtype=dtype)`` on NHWC: input, (O, I, kh, kw) weight
    and bias cast to ``dtype``, symmetric padding, NHWC out in ``dtype``."""
    with _conv_precision(dtype):
        y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), weight.to(dtype),
                     None if bias is None else bias.to(dtype), padding=padding)
    return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5)`` over the last axis in
    f32, in flax's order: (x - mean) * (rsqrt(var + eps) * scale) + bias.

    Eval mode normalises with the running statistics. Training mode takes the
    mean and flax's fast variance E[x^2] - E[x]^2 (clipped at 0) over every
    axis but the last, normalises with them (gradients flow through both) and
    updates the buffers in place as running = 0.9 * running + 0.1 * batch,
    with the same *biased* variance. ``nn.BatchNorm2d`` differs in both
    conventions (it stores the unbiased variance, and its momentum weighs
    the batch), so it is not used.

    With ``group`` set (parallel/mesh.py ``place_train_state`` sets it to the
    "data" processes) the statistics are those of the global batch, as the
    reference's SyncBN and its global arrays give them: the per-channel sum,
    sum of squares and count are summed over the group, with the gradients
    through the sum, and the running buffers take the global statistics."""

    def __init__(self, dim: int, eps: float = 1e-5, momentum: float = 0.9, device=None):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.group = None
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.register_buffer("running_mean", torch.zeros(dim, device=device))
        self.register_buffer("running_var", torch.ones(dim, device=device))

    def _global_moments(self, x, axes):
        """(mean, E[x^2]) over the group's global batch."""
        from mem_tpu_torch.parallel.mesh import all_reduce_sum

        count = torch.full((1,), x.numel() // x.shape[-1], dtype=x.dtype, device=x.device)
        sums = all_reduce_sum(torch.cat([x.sum(dim=axes), (x * x).sum(dim=axes), count]),
                              self.group)
        c = x.shape[-1]
        return sums[:c] / sums[-1], sums[c: 2 * c] / sums[-1]

    def forward(self, x):
        x = x.float()
        if self.training:
            axes = tuple(range(x.ndim - 1))
            if self.group is not None:
                mean, mean2 = self._global_moments(x, axes)
            else:
                mean, mean2 = x.mean(dim=axes), (x * x).mean(dim=axes)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
                self.running_var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


class ConvModule(nn.Module):
    """conv + BN + ReLU (mmseg ConvModule with norm_cfg=SyncBN): the conv in
    the compute dtype without a bias, the BN in f32."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(in_ch, features, kernel, padding=kernel // 2, bias=False,
                              device=device)
        self.bn = BatchNorm(features, device=device)

    def forward(self, x):
        y = conv2d_nhwc(x, self.conv.weight, None, self.conv.padding[0], self.dtype)
        return F.relu(self.bn(y))


class EvBEiT(VitEncoder):
    """Backbone (mem.py:277-452): internal resize to ``img_size``^2, the ViT
    trunk with a per-block rel-pos bias, block taps + FPN necks. Returns 4
    NHWC features at strides {4, 8, 16, 32} of the ``img_size`` canvas."""

    def __init__(self, img_size: int = 512, patch_size: int = 16, in_chans: int = 3,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.1,
                 init_values: Optional[float] = 0.1, use_abs_pos_emb: bool = False,
                 use_rel_pos_bias: bool = True, out_indices: Sequence[int] = (8, 9, 10, 11),
                 dtype=torch.float32, device=None):
        grid = img_size // patch_size
        super().__init__(embed_dim, depth, num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                         init_values=init_values, use_rel_pos_bias=use_rel_pos_bias,
                         window_size=(grid, grid), dropout=drop_rate,
                         attn_dropout=attn_drop_rate, drop_path_rate=drop_path_rate,
                         dtype=dtype, device=device)
        self.img_size = img_size
        self.grid = grid
        self.out_indices = tuple(out_indices)
        self.dtype = dtype
        self.drop_rate = drop_rate
        self.patch_embed = PatchEmbed((patch_size, patch_size), in_chans, embed_dim,
                                      dtype=dtype, device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim, device=device))
        self.pos_embed = (nn.Parameter(torch.zeros(1, grid * grid + 1, embed_dim,
                                                   device=device))
                          if use_abs_pos_emb else None)
        d = embed_dim
        self.fpn1_deconv1 = TorchConvTranspose(d, d, 2, stride=2, dtype=dtype, device=device)
        self.fpn1_bn = BatchNorm(d, device=device)
        self.fpn1_deconv2 = TorchConvTranspose(d, d, 2, stride=2, dtype=dtype, device=device)
        self.fpn2_deconv = TorchConvTranspose(d, d, 2, stride=2, dtype=dtype, device=device)

    def forward(self, x, train: bool = False, generator=None):
        _check_mode(self, train)
        B = x.shape[0]
        x = _upsample(x, self.img_size, self.img_size)
        tokens = self.patch_embed(x)
        cls = self.cls_token.to(tokens.dtype).expand(B, 1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
        if self.pos_embed is not None:
            tokens = tokens + self.pos_embed.to(tokens.dtype)
        if train and self.drop_rate > 0:
            tokens = dropout(tokens, self.drop_rate,
                             _need_generator(generator, "EvBEiT token dropout"))
        feats_all = self.encode(tokens, generator, return_all=True)
        taps = [feats_all[i][:, 1:, :].reshape(B, self.grid, self.grid, -1).float()
                for i in self.out_indices]

        # FPN necks (mem.py:332-360, the patch_size == 16 branch)
        f1 = self.fpn1_bn(self.fpn1_deconv1(taps[0]))
        f1 = self.fpn1_deconv2(F.gelu(f1, approximate="none"))
        f2 = self.fpn2_deconv(taps[1])
        f3 = taps[2]
        f4 = F.max_pool2d(taps[3].permute(0, 3, 1, 2), 2, stride=2).permute(0, 2, 3, 1)
        return [f1, f2, f3, f4]


class UPerHead(nn.Module):
    """UPerNet decode head (mmseg UPerHead semantics)."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], channels: int = 512,
                 pool_scales: Sequence[int] = (1, 2, 3, 6), dropout_ratio: float = 0.1,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dropout_ratio = dropout_ratio
        self.pool_scales = tuple(pool_scales)
        self.n_inputs = len(in_channels)
        kw = dict(dtype=dtype, device=device)
        for si in range(len(self.pool_scales)):
            setattr(self, f"psp_{si}", ConvModule(in_channels[-1], channels, 1, **kw))
        self.psp_bottleneck = ConvModule(
            in_channels[-1] + len(self.pool_scales) * channels, channels, 3, **kw)
        for i in range(self.n_inputs - 1):
            setattr(self, f"lateral_{i}", ConvModule(in_channels[i], channels, 1, **kw))
            setattr(self, f"fpn_{i}", ConvModule(channels, channels, 3, **kw))
        self.fpn_bottleneck = ConvModule(self.n_inputs * channels, channels, 3, **kw)
        self.conv_seg = nn.Conv2d(channels, num_classes, 1, device=device)

    def forward(self, inputs, train: bool = False, generator=None):
        _check_mode(self, train)
        # PSP on the deepest feature
        x = inputs[-1].float()
        B, H, W, C = x.shape
        psp_outs = [x]
        for si, s in enumerate(self.pool_scales):
            py = cached(("adaptive_pool", s, H), torch.float32, x.device,
                        lambda: adaptive_pool_matrix(s, H))
            px = cached(("adaptive_pool", s, W), torch.float32, x.device,
                        lambda: adaptive_pool_matrix(s, W))
            pooled = torch.einsum("oh,bhwc->bowc", py, x)
            pooled = torch.einsum("pw,bowc->bopc", px, pooled)
            psp_outs.append(_upsample(getattr(self, f"psp_{si}")(pooled), H, W))
        feat = self.psp_bottleneck(torch.cat(psp_outs, dim=-1))

        # FPN top-down
        laterals = [getattr(self, f"lateral_{i}")(inputs[i])
                    for i in range(self.n_inputs - 1)] + [feat]
        for i in range(len(laterals) - 1, 0, -1):
            h, w = laterals[i - 1].shape[1:3]
            laterals[i - 1] = laterals[i - 1] + _upsample(laterals[i], h, w)
        fpn_outs = [getattr(self, f"fpn_{i}")(laterals[i])
                    for i in range(len(laterals) - 1)] + [laterals[-1]]
        h0, w0 = fpn_outs[0].shape[1:3]
        fpn_outs = [fpn_outs[0]] + [_upsample(f, h0, w0) for f in fpn_outs[1:]]
        out = self.fpn_bottleneck(torch.cat(fpn_outs, dim=-1))
        if train and self.dropout_ratio > 0:
            out = dropout(out, self.dropout_ratio,
                          _need_generator(generator, "UPerHead dropout"))
        return conv2d_nhwc(out, self.conv_seg.weight, self.conv_seg.bias, 0, torch.float32)


class FCNHead(nn.Module):
    """Auxiliary FCN head (1 conv, concat_input=False)."""

    def __init__(self, num_classes: int, in_channels: int, channels: int = 256,
                 dropout_ratio: float = 0.1, dtype=torch.float32, device=None):
        super().__init__()
        self.dropout_ratio = dropout_ratio
        self.conv0 = ConvModule(in_channels, channels, 3, dtype=dtype, device=device)
        self.conv_seg = nn.Conv2d(channels, num_classes, 1, device=device)

    def forward(self, x, train: bool = False, generator=None):
        _check_mode(self, train)
        x = self.conv0(x)
        if train and self.dropout_ratio > 0:
            x = dropout(x, self.dropout_ratio, _need_generator(generator, "FCNHead dropout"))
        return conv2d_nhwc(x, self.conv_seg.weight, self.conv_seg.bias, 0, torch.float32)


class EncoderDecoder(nn.Module):
    """EvBEiT + UPerHead + the FCN auxiliary head (config
    mem_224_160k.py:33-77). Input NHWC at any size (DSEC: 440x640); both
    logit maps are upsampled back to the input resolution, NHWC f32."""

    def __init__(self, num_classes: int = 11, backbone_cfg: Optional[dict] = None,
                 aux_in_index: int = 2, head_channels: int = 512, aux_channels: int = 256,
                 dropout_ratio: float = 0.1, dtype=torch.float32, device=None):
        super().__init__()
        cfg = dict(backbone_cfg or {})
        cfg.setdefault("dtype", dtype)
        self.num_classes = num_classes
        self.aux_in_index = aux_in_index
        self.backbone = EvBEiT(device=device, **cfg)
        d = self.backbone.patch_embed.proj.out_channels
        self.decode_head = UPerHead(num_classes, (d,) * 4, channels=head_channels,
                                    dropout_ratio=dropout_ratio, dtype=dtype, device=device)
        self.auxiliary_head = FCNHead(num_classes, d, channels=aux_channels,
                                      dropout_ratio=dropout_ratio, dtype=dtype, device=device)

    def forward(self, x, train: bool = False, generator=None):
        _check_mode(self, train)
        H, W = x.shape[1:3]
        feats = self.backbone(x, train, generator)
        logits = self.decode_head(feats, train, generator)
        aux = self.auxiliary_head(feats[self.aux_in_index], train, generator)
        return _upsample(logits, H, W), _upsample(aux, H, W)

    def init_weights(self, generator: torch.Generator, init_std: float = 0.02) -> None:
        """Seeded init: the trunk as the classifier's (truncated normal, the
        depth rescale), convolutions N(0, 1 / fan_in) (flax's lecun normal up
        to the truncation), BatchNorm at identity."""
        bk = self.backbone
        VitEncoder.init_weights(bk, generator, init_std)
        trunc_normal_(bk.patch_embed.proj.weight, init_std, generator)
        nn.init.zeros_(bk.patch_embed.proj.bias)
        trunc_normal_(bk.cls_token, init_std, generator)
        if bk.pos_embed is not None:
            trunc_normal_(bk.pos_embed, init_std, generator)
        for m in self.modules():
            if m is bk.patch_embed.proj or not isinstance(m, (nn.Conv2d, TorchConvTranspose)):
                continue
            # Conv2d (O, I, kh, kw): I * kh * kw inputs reach one output; the
            # non-overlapping transposed conv (I, O, k, k): I inputs do
            fan_in = m.weight.shape[0] if isinstance(m, TorchConvTranspose) \
                else m.weight[0].numel()
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator,
                                           device=generator.device) / math.sqrt(fan_in))
            if m.bias is not None:
                nn.init.zeros_(m.bias)


def build_segmentor(num_classes: int, seg_input_size: int, embed_dim: int, depth: int,
                    num_heads: int, dtype, device, drop_path_rate: float = 0.1,
                    dropout_ratio: float = 0.1) -> EncoderDecoder:
    """The segmentor the CLIs build (train_seg.py:224-233, test_seg.py:80-88,
    serve.py:386-394): EvBEiT at ``seg_input_size``^2 tapping the last four
    blocks."""
    return EncoderDecoder(
        num_classes=num_classes,
        backbone_cfg=dict(
            img_size=seg_input_size, embed_dim=embed_dim, depth=depth, num_heads=num_heads,
            drop_path_rate=drop_path_rate,
            out_indices=tuple(max(0, depth - 4 + k) for k in range(4)),
        ),
        dropout_ratio=dropout_ratio, dtype=dtype, device=device)


def seg_loss(logits, aux, labels, num_classes: int, aux_weight: float = 0.4,
             ignore_index: int = 255, group=None):
    """CE (+0.4 aux) with ignore_index semantics (mmseg CrossEntropyLoss):
    mean over the valid pixels of logsumexp - logit[label]. With ``group``
    (the "data" processes) the valid pixels are counted over the global batch
    (parallel/mesh.py ``global_quotient``)."""
    from mem_tpu_torch.parallel.mesh import global_quotient

    valid = labels != ignore_index
    lab = torch.where(valid, labels, torch.zeros_like(labels)).long()
    denom = valid.sum().clamp(min=1)

    def ce(lg):
        lg = lg.float()
        tgt = torch.gather(lg, -1, lab[..., None])[..., 0]
        lp = tgt - torch.logsumexp(lg, dim=-1)
        return global_quotient(-(lp * valid).sum(), denom, group)

    return ce(logits) + aux_weight * ce(aux)


def tta_probs(apply_fn, images, num_classes: int, scales, flips):
    """Multi-scale / horizontal-flip test-time augmentation: the sum of the
    softmax probabilities over every (scale, flip) pass, each resized back
    to the input grid and un-flipped (mmseg aug_test semantics).

    ``apply_fn(x) -> logits`` returns per-pixel class logits at x's
    resolution. ``scales=[1.0]``, ``flips=[False]`` is single-scale
    inference. The resizes are the antialiased bilinear of ops/image_ops
    (``jax.image.resize(method="bilinear")`` in the reference)."""
    B, H, W, _ = images.shape
    prob_sum = torch.zeros(B, H, W, num_classes, dtype=torch.float32, device=images.device)
    for s in scales:
        sh, sw = int(round(H * s)), int(round(W * s))
        img_s = images if (sh, sw) == (H, W) else resize_bilinear(images, sh, sw)
        for flip in flips:
            x = img_s.flip(2) if flip else img_s
            prob = torch.softmax(apply_fn(x).float(), dim=-1)
            if flip:
                prob = prob.flip(2)
            if (sh, sw) != (H, W):
                prob = resize_bilinear(prob, H, W)
            prob_sum = prob_sum + prob
    return prob_sum


def confusion_matrix(pred, labels, num_classes: int, ignore_index: int = 255):
    """(num_classes, num_classes) f32 confusion counts as a one-hot product
    (gt rows, pred cols): the mIoU / mDice / mFscore accumulator."""
    valid = (labels != ignore_index).reshape(-1)
    p = pred.reshape(-1).long()
    lab = torch.where(valid, labels.reshape(-1), torch.zeros_like(labels.reshape(-1))).long()
    oh_l = F.one_hot(lab, num_classes).float() * valid[:, None]
    oh_p = F.one_hot(p, num_classes).float()
    return oh_l.t() @ oh_p


def seg_metrics(cm) -> dict:
    """mIoU / mAcc / aAcc / mDice / mFscore from a confusion matrix
    (EventDataset.py:418-517 metric surface)."""
    cm = np.asarray(cm, dtype=np.float64)
    tp = np.diag(cm)
    gt = cm.sum(1)
    pr = cm.sum(0)
    union = gt + pr - tp
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, tp / union, np.nan)
        acc = np.where(gt > 0, tp / gt, np.nan)
        dice = np.where(gt + pr > 0, 2 * tp / (gt + pr), np.nan)
        precision = np.where(pr > 0, tp / pr, np.nan)
        recall = np.where(gt > 0, tp / gt, np.nan)
        f1 = np.where(
            precision + recall > 0, 2 * precision * recall / (precision + recall), np.nan
        )
    return {
        "aAcc": float(tp.sum() / max(cm.sum(), 1)),
        "mIoU": float(np.nanmean(iou)),
        "mAcc": float(np.nanmean(acc)),
        "mDice": float(np.nanmean(dice)),
        "mFscore": float(np.nanmean(f1)),
        "IoU": iou,
        "Acc": acc,
    }
