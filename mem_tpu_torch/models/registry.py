"""Model registry — ``create_model(name, **kwargs)``, port of
mem_tpu/models/registry.py. ``pt_vit``, ``ft_vit`` and ``event_vae`` are
ported; the MAE models of the reference come with their slice."""
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
def event_vae(**kwargs):
    """Discrete event VAE tokenizer (reference ``event_vae``)."""
    from mem_tpu_torch.models.discrete_vae import DiscreteVAE

    kwargs.pop("pretrained", None)
    return DiscreteVAE(**kwargs)
