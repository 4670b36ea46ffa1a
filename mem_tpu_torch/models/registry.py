"""Model registry — ``create_model(name, **kwargs)``, port of
mem_tpu/models/registry.py: every model of the reference's registry."""
from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register_model(fn: Callable) -> Callable:
    _REGISTRY[fn.__name__] = fn
    return fn


def list_models():
    return sorted(_REGISTRY)


def create_model(name: str, **kwargs):
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; available: {list_models()}")
    return _REGISTRY[name](**kwargs)


@register_model
def pt_vit(**kwargs):
    """BEiT-style masked-event-modeling ViT (reference ``pt_vit``)."""
    from mem_tpu_torch.models.pretrain import VisionTransformerForMaskedImageModeling

    kwargs.pop("pretrained", None)
    return VisionTransformerForMaskedImageModeling(**kwargs)


@register_model
def ft_vit(**kwargs):
    """Classification ViT (reference ``ft_vit``)."""
    from mem_tpu_torch.models.classifier import VisionTransformer

    kwargs.pop("pretrained", None)
    return VisionTransformer(**kwargs)


@register_model
def mae_vit_base_patch16_dec512d8b(**kwargs):
    """MAE ViT-B/16 with a 512-wide, 8-block decoder (reference
    modeling_mae.py:306)."""
    from mem_tpu_torch.models.mae import MaskedAutoencoderViT

    kwargs.pop("pretrained", None)
    return MaskedAutoencoderViT(patch_size=16, embed_dim=768, depth=12, num_heads=12,
                                decoder_embed_dim=512, decoder_depth=8, decoder_num_heads=16,
                                **kwargs)


@register_model
def vit_base_patch16(**kwargs):
    """timm-style ViT-B/16 for MAE finetuning (reference
    run_class_finetuning.py:78-82, the global-pool VisionTransformer). The
    base/16 geometry is the default; explicit kwargs override it, as the
    reference's registry allows (registry.py:59-74)."""
    from mem_tpu_torch.models.mae_classifier import MAEVisionTransformer

    kwargs.pop("pretrained", None)
    for k, v in (("patch_size", 16), ("embed_dim", 768), ("depth", 12), ("num_heads", 12),
                 ("mlp_ratio", 4.0)):
        kwargs.setdefault(k, v)
    return MAEVisionTransformer(**kwargs)


@register_model
def event_vae(**kwargs):
    """Discrete event VAE tokenizer (reference ``event_vae``)."""
    from mem_tpu_torch.models.discrete_vae import DiscreteVAE

    kwargs.pop("pretrained", None)
    return DiscreteVAE(**kwargs)
