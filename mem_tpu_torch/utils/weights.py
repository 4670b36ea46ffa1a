"""Carry ``ft_vit`` / ``pt_vit``, MAE, discrete-VAE and segmentor weights
from flax parameter trees into the port.

The ViT state_dict keys are the reference's torch schema, the one
mem_tpu/utils/torch_import.py ``export_vit_params`` (:122-173) writes and
``python -m mem_tpu.cli.export_torch`` saves, so the port's models'
``load_state_dict(sd, strict=True)`` takes either. The VAE keys are the
reference DiscreteVAE's ``nn.Sequential`` indices, the schema
``import_vae_state_dict`` (torch_import.py:385-419) reads, and for the legacy
VAE the schema ``import_legacy_vae_state_dict`` (:422-450) reads. The segmentor keys are those of
``export_seg_params`` (torch_import.py:453-498), the MAE's and the MAE
classifier's those of ``export_mae_params`` / ``export_mae_classifier_params``
(:176, :214). Flax Dense
kernels are (in, out) and torch Linear weights (out, in); conv kernels
(kh, kw, I, O) become torch (O, I, kh, kw), transposed-conv kernels
(kh, kw, I, O) torch (I, O, kh, kw).
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch


_CONV = (3, 2, 0, 1)      # flax (kh, kw, I, O) -> torch Conv2d (O, I, kh, kw)
_CONV_T = (2, 3, 0, 1)    # flax (kh, kw, I, O) -> torch ConvTranspose2d (I, O, kh, kw)


def _putter(sd):
    def put(name, v, transpose=None):
        a = np.asarray(v)
        if transpose is not None:
            a = np.transpose(a, transpose)
        sd[name] = torch.from_numpy(np.array(a, copy=True, order="C"))

    return put


def from_jax_params(tree: Dict) -> Dict[str, torch.Tensor]:
    """flax variables ``{"params": ..., ["batch_stats": ...]}`` with numpy
    (or array-like) leaves -> torch state_dict for the port's ft_vit or
    pt_vit (``mask_token``, ``lm_head``). The linear probe's BatchNorm
    running statistics come from ``batch_stats``."""
    p = tree["params"]
    sd: Dict[str, torch.Tensor] = {}

    put = _putter(sd)
    if "patch_embed" in p:
        put("patch_embed.proj.weight", p["patch_embed"]["proj"]["kernel"], _CONV)
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
    for nm in ("lm_head", "head"):
        if nm in p:
            put(f"{nm}.weight", p[nm]["kernel"], (1, 0))
            put(f"{nm}.bias", p[nm]["bias"])
    bn = tree.get("batch_stats", {}).get("batch_norm")
    if bn is not None:
        put("batch_norm.running_mean", bn["mean"])
        put("batch_norm.running_var", bn["var"])
    return sd


def normalize_backbone_state_dict(sd: Dict) -> Dict:
    """Reduce a raw seg / pretraining state_dict to backbone naming
    (torch_import.py:366-382, the reference's train_api.py:502-523
    handshake): drop a ``module.`` DDP prefix, and where keys carry a
    ``backbone.`` prefix (a segmentation checkpoint) keep those, stripped. A
    pretraining or finetune checkpoint passes through unchanged."""
    if next(iter(sd)).startswith("module."):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    if any(k.startswith("backbone.") for k in sd):
        sd = {k[len("backbone."):]: v for k, v in sd.items() if k.startswith("backbone.")}
    return sd


def load_timm_npz(path: str) -> Dict[str, np.ndarray]:
    """An original jax-ViT ``.npz`` checkpoint (the format timm's
    ``load_checkpoint`` reads for ``B_16-i1k``-style files) as a timm-named
    dict in torch layouts, mem_tpu/utils/torch_import.py ``load_timm_npz``
    (:295-364): ``embedding`` -> patch_embed.proj, ``cls`` -> cls_token,
    ``Transformer/posembed_input/pos_embedding`` -> pos_embed,
    ``encoderblock_N/LayerNorm_0|2`` -> norm1|norm2,
    ``MultiHeadDotProductAttention_1/{query,key,value,out}`` -> the fused
    qkv and proj, ``MlpBlock_3/Dense_0|1`` -> mlp.fc1|fc2,
    ``Transformer/encoder_norm`` -> norm, and ``head`` / ``pre_logits``
    under their timm names. A consumer takes the names it has, as the
    reference's ``copy_tmpModelTimm_to_semsegBackbone`` does."""
    z = np.load(path)
    sd: Dict[str, np.ndarray] = {
        "patch_embed.proj.weight": np.transpose(z["embedding/kernel"], (3, 2, 0, 1)),
        "patch_embed.proj.bias": np.asarray(z["embedding/bias"]),
        "cls_token": np.asarray(z["cls"]),
        "pos_embed": np.asarray(z["Transformer/posembed_input/pos_embedding"]),
        "norm.weight": np.asarray(z["Transformer/encoder_norm/scale"]),
        "norm.bias": np.asarray(z["Transformer/encoder_norm/bias"]),
    }
    i = 0
    while f"Transformer/encoderblock_{i}/LayerNorm_0/scale" in z:
        b, t = f"Transformer/encoderblock_{i}", f"blocks.{i}"
        for ln, src in (("norm1", "LayerNorm_0"), ("norm2", "LayerNorm_2")):
            sd[f"{t}.{ln}.weight"] = np.asarray(z[f"{b}/{src}/scale"])
            sd[f"{t}.{ln}.bias"] = np.asarray(z[f"{b}/{src}/bias"])
        a = f"{b}/MultiHeadDotProductAttention_1"
        D = z[f"{a}/query/kernel"].shape[0]
        # (D, H, hd) kernels -> torch (D_out, D_in) rows, q; k; v fused
        sd[f"{t}.attn.qkv.weight"] = np.concatenate(
            [np.asarray(z[f"{a}/{n}/kernel"]).reshape(D, -1).T
             for n in ("query", "key", "value")], axis=0)
        sd[f"{t}.attn.qkv.bias"] = np.concatenate(
            [np.asarray(z[f"{a}/{n}/bias"]).reshape(-1) for n in ("query", "key", "value")])
        sd[f"{t}.attn.proj.weight"] = np.asarray(z[f"{a}/out/kernel"]).reshape(-1, D).T
        sd[f"{t}.attn.proj.bias"] = np.asarray(z[f"{a}/out/bias"]).reshape(-1)
        for fc, dense in (("fc1", "Dense_0"), ("fc2", "Dense_1")):
            sd[f"{t}.mlp.{fc}.weight"] = np.asarray(z[f"{b}/MlpBlock_3/{dense}/kernel"]).T
            sd[f"{t}.mlp.{fc}.bias"] = np.asarray(z[f"{b}/MlpBlock_3/{dense}/bias"])
        i += 1
    if i == 0:
        raise ValueError(f"{path}: no Transformer/encoderblock_* entries -- not a jax-ViT "
                         f"npz checkpoint")
    for name, key in (("head", "head"), ("pre_logits.fc", "pre_logits")):
        if f"{key}/kernel" in z:
            sd[f"{name}.weight"] = np.asarray(z[f"{key}/kernel"]).T
            sd[f"{name}.bias"] = np.asarray(z[f"{key}/bias"])
    return sd


def _timm_blocks(put, p, pattern):
    """The ``TimmBlock`` subtrees of ``p`` whose names match ``pattern`` (a
    regex with an optional ``decoder_`` group and the block index)."""
    for name, sub in p.items():
        m = re.fullmatch(pattern, name)
        if not m:
            continue
        b = f"{m.group(1) or ''}blocks.{m.group(2)}"
        for ln in ("norm1", "norm2"):
            put(f"{b}.{ln}.weight", sub[ln]["scale"])
            put(f"{b}.{ln}.bias", sub[ln]["bias"])
        for lin in ("qkv", "proj", "fc1", "fc2"):
            put(f"{b}.{lin}.weight", sub[lin]["kernel"], (1, 0))
            put(f"{b}.{lin}.bias", sub[lin]["bias"])


def mae_from_jax_params(tree: Dict) -> Dict[str, torch.Tensor]:
    """flax ``MaskedAutoencoderViT`` variables ``{"params": ...}`` -> the
    port's MAE state_dict, ``export_mae_params``'s keys and layouts (the
    sin-cos tables are buffers on both sides, not parameters)."""
    p = tree["params"]
    sd: Dict[str, torch.Tensor] = {}
    put = _putter(sd)
    put("patch_embed.weight", p["patch_embed"]["kernel"], _CONV)
    put("patch_embed.bias", p["patch_embed"]["bias"])
    put("cls_token", p["cls_token"])
    put("mask_token", p["mask_token"])
    _timm_blocks(put, p, r"(decoder_)?blocks_(\d+)")
    for nm in ("norm", "decoder_norm"):
        put(f"{nm}.weight", p[nm]["scale"])
        put(f"{nm}.bias", p[nm]["bias"])
    for nm in ("decoder_embed", "decoder_pred"):
        put(f"{nm}.weight", p[nm]["kernel"], (1, 0))
        put(f"{nm}.bias", p[nm]["bias"])
    return sd


def mae_classifier_from_jax_params(tree: Dict) -> Dict[str, torch.Tensor]:
    """flax ``MAEVisionTransformer`` variables -> the port's MAE classifier
    state_dict, ``export_mae_classifier_params``'s keys and layouts."""
    p = tree["params"]
    sd: Dict[str, torch.Tensor] = {}
    put = _putter(sd)
    put("patch_embed.weight", p["patch_embed"]["kernel"], _CONV)
    put("patch_embed.bias", p["patch_embed"]["bias"])
    put("cls_token", p["cls_token"])
    put("pos_embed", p["pos_embed"])
    _timm_blocks(put, p, r"()blocks_(\d+)")
    for nm in ("fc_norm", "norm"):
        if nm in p:
            put(f"{nm}.weight", p[nm]["scale"])
            put(f"{nm}.bias", p[nm]["bias"])
    put("head.weight", p["head"]["kernel"], (1, 0))
    put("head.bias", p["head"]["bias"])
    return sd


def normalize_mae_state_dict(sd: Dict) -> Dict:
    """An MAE state_dict in the original timm naming (``patch_embed.proj.*``,
    ``blocks.N.attn.qkv.*``, ``blocks.N.mlp.fc1.*``) -> the port's keys, the
    renaming ``import_mae_state_dict`` (torch_import.py:246) accepts:
    ``patch_embed.proj.`` -> ``patch_embed.``, ``.attn.`` and ``.mlp.``
    dropped, the ``decoder_pos_embed`` buffer dropped. ``pos_embed`` stays
    for the surgery. Keys already in the port's naming pass unchanged."""
    out = {}
    for key, w in sd.items():
        k = key.replace(".attn.", ".").replace(".mlp.", ".")
        if k.startswith("patch_embed.proj."):
            k = "patch_embed." + k[len("patch_embed.proj."):]
        if k != "decoder_pos_embed":
            out[k] = w
    return out


def vae_from_jax_params(tree: Dict) -> Dict[str, torch.Tensor]:
    """flax ``DiscreteVAE`` variables ``{"params": ...}`` -> the reference
    VAE state_dict, decoder included: ``codebook.weight``; encoder
    ``[Seq(Conv, ReLU)] * L + [ResBlock] * R + [Conv1x1]``; decoder
    ``[Conv1x1 if R] + [ResBlock] * R + [Seq(ConvT, ReLU)] * L + [Conv1x1]``
    (the inverse of torch_import.py:385-419)."""
    p = tree["params"]
    sd: Dict[str, torch.Tensor] = {}
    put = _putter(sd)
    L = sum(1 for k in p if re.fullmatch(r"enc_conv_\d+", k))
    R = sum(1 for k in p if re.fullmatch(r"enc_res_\d+", k))

    def conv(prefix, sub, transpose=_CONV):
        put(f"{prefix}.weight", sub["kernel"], transpose)
        put(f"{prefix}.bias", sub["bias"])

    def res(prefix, sub):
        for ti, name in ((0, "conv1"), (2, "conv2"), (4, "conv3")):
            conv(f"{prefix}.net.{ti}", sub[name])

    put("codebook.weight", p["codebook"]["embedding"])
    for i in range(L):
        conv(f"encoder.{i}.0", p[f"enc_conv_{i}"])
    for j in range(R):
        res(f"encoder.{L + j}", p[f"enc_res_{j}"])
    conv(f"encoder.{L + R}", p["enc_head"])
    off = 0
    if R > 0:
        conv("decoder.0", p["dec_in"])
        off = 1
    for j in range(R):
        res(f"decoder.{off + j}", p[f"dec_res_{j}"])
    for i in range(L):
        conv(f"decoder.{off + R + i}.0", p[f"dec_deconv_{i}"], _CONV_T)
    conv(f"decoder.{off + R + L}", p["dec_head"])
    return sd


def legacy_vae_from_jax_params(tree: Dict) -> Dict[str, torch.Tensor]:
    """flax ``LegacyDiscreteVAE`` variables -> the reference legacy VAE
    state_dict: encoder ``[Seq(Conv, ReLU), ResBlock] * L + [Conv1x1]``,
    decoder ``[Seq(ConvT, ReLU), ResBlock] * L + [Conv1x1]`` (the inverse of
    torch_import.py:422-450)."""
    p = tree["params"]
    sd: Dict[str, torch.Tensor] = {}
    put = _putter(sd)
    L = sum(1 for k in p if re.fullmatch(r"enc_conv_\d+", k))

    def conv(prefix, sub, transpose=_CONV):
        put(f"{prefix}.weight", sub["kernel"], transpose)
        put(f"{prefix}.bias", sub["bias"])

    put("codebook.weight", p["codebook"]["embedding"])
    for i in range(L):
        conv(f"encoder.{2 * i}.0", p[f"enc_conv_{i}"])
        conv(f"decoder.{2 * i}.0", p[f"dec_deconv_{i}"], _CONV_T)
        for stack, name in (("encoder", "enc_res"), ("decoder", "dec_res")):
            for ti, sub in ((0, "conv1"), (2, "conv2"), (4, "conv3")):
                conv(f"{stack}.{2 * i + 1}.net.{ti}", p[f"{name}_{i}"][sub])
    conv(f"encoder.{2 * L}", p["enc_head"])
    conv(f"decoder.{2 * L}", p["dec_head"])
    return sd


def seg_from_jax_params(variables: Dict) -> Dict[str, torch.Tensor]:
    """flax ``EncoderDecoder`` variables ``{"params": ..., "batch_stats":
    ...}`` with numpy (or array-like) leaves -> torch state_dict for the
    port's ``models.segmentation.EncoderDecoder``, in the keys
    ``export_seg_params`` writes: the backbone trunk under ``backbone.``,
    the FPN necks, every ConvModule's conv and BatchNorm with its running
    statistics, and the two ``conv_seg`` classifiers."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    put = _putter(sd)

    bk = params["backbone"]
    for name, v in from_jax_params({"params": bk}).items():
        sd[f"backbone.{name}"] = v

    def put_bn(prefix, p, s):
        put(f"{prefix}.weight", p["scale"])
        put(f"{prefix}.bias", p["bias"])
        put(f"{prefix}.running_mean", s["mean"])
        put(f"{prefix}.running_var", s["var"])

    for name in ("fpn1_deconv1", "fpn1_deconv2", "fpn2_deconv"):
        put(f"backbone.{name}.weight", bk[name]["kernel"], _CONV_T)
        put(f"backbone.{name}.bias", bk[name]["bias"])
    put_bn("backbone.fpn1_bn", bk["fpn1_bn"], stats["backbone"]["fpn1_bn"])

    for head in ("decode_head", "auxiliary_head"):
        hp, hs = params[head], stats.get(head, {})
        for name, sub in sorted(hp.items()):
            if name == "conv_seg":
                put(f"{head}.conv_seg.weight", sub["kernel"], _CONV)
                put(f"{head}.conv_seg.bias", sub["bias"])
            else:   # ConvModule: conv without a bias + BN
                put(f"{head}.{name}.conv.weight", sub["conv"]["kernel"], _CONV)
                put_bn(f"{head}.{name}.bn", sub["bn"], hs[name]["bn"])
    return sd
