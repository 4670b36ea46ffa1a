"""The frozen discrete-VAE event tokenizer (encoder only) and the
non-overlapping ``TorchConvTranspose`` the segmentation necks use; port of
mem_tpu/models/discrete_vae.py (:147-247; the reference's
eventvae/vae/vae_model.py:45-158).

``num_layers`` stride-2 4x4 convs with ReLU, ``num_resnet_blocks`` ResBlocks
(conv3x3-ReLU-conv3x3-ReLU-conv1x1 + skip) and a 1x1 head to
``num_tokens`` logits; ``get_codebook_indices`` is the argmax over them.
The modules are laid out as the reference's ``nn.Sequential`` so the
reference VAE state_dict keys (``encoder.{i}.0.*``, ``encoder.{L+j}.net.*``,
``encoder.{L+R}.*``, ``codebook.weight``; the schema
mem_tpu/utils/torch_import.py ``import_vae_state_dict`` reads) load as they
are; the decoder keys of a full state_dict are ignored (the decoder comes
with the VAE-training slice).

The pretraining CLI builds the VAE in f32 (run_mem_pretraining.py:262-271),
so the port runs it in f32 with cuDNN's TF32 off: PyTorch's default would
run the f32 convolutions in TF32 on the card and change the labels.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn


class ResBlock(nn.Module):
    def __init__(self, chan: int, device=None):
        super().__init__()
        self.net = nn.Sequential(
            nn.Conv2d(chan, chan, 3, padding=1, device=device), nn.ReLU(),
            nn.Conv2d(chan, chan, 3, padding=1, device=device), nn.ReLU(),
            nn.Conv2d(chan, chan, 1, device=device))

    def forward(self, x):
        return self.net(x) + x


@contextlib.contextmanager
def cudnn_full_f32():
    """cuDNN convolutions in full f32 (no TF32) for the duration."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class TorchConvTranspose(nn.Module):
    """ConvTranspose2d with torch's semantics on NHWC tensors, the role of
    the reference's ``TorchConvTranspose`` (discrete_vae.py:99), for the
    non-overlapping case kernel == stride, padding 0: the 2x2 stride-2
    deconvolutions of the segmentation necks. Every input pixel then writes
    its own k x k output patch, so the layer is one product
    ``x @ W.reshape(I, O * k * k)`` and a reshuffle, with no convolution
    library involved. ``weight`` is torch's (I, O, k, k). As flax's
    ``dtype=`` does, input, weight and bias are cast to the compute dtype
    and the bias is added after the product is rounded. The VAE decoder's
    kernel-4 stride-2 padding-1 case comes with the VAE-training slice."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 2, stride: int = 2,
                 padding: int = 0, dtype=torch.float32, device=None):
        super().__init__()
        if kernel_size != stride or padding != 0:
            raise NotImplementedError(
                f"TorchConvTranspose(kernel {kernel_size}, stride {stride}, padding "
                f"{padding}): only kernel == stride, padding 0 is ported; the VAE "
                f"decoder's 4/2/1 case comes with the VAE-training slice")
        self.k = kernel_size
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(in_ch, features, kernel_size, kernel_size,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        B, H, W, C = x.shape
        k, O = self.k, self.weight.shape[1]
        w = self.weight.to(self.dtype).reshape(C, O * k * k)
        y = torch.matmul(x.to(self.dtype), w).reshape(B, H, W, O, k, k)
        y = y.permute(0, 1, 4, 2, 5, 3).reshape(B, H * k, W * k, O)
        return y + self.bias.to(self.dtype)


class DiscreteVAE(nn.Module):
    def __init__(self, input_hw: Tuple[int, int] = (224, 224), num_tokens: int = 8192,
                 codebook_dim: int = 32, num_layers: int = 4, num_resnet_blocks: int = 3,
                 hidden_dim: int = 384, channels: int = 3,
                 normalization: Optional[Tuple[Sequence[float], Sequence[float]]] = None,
                 device=None):
        super().__init__()
        if input_hw[0] % 2 ** num_layers or input_hw[1] % 2 ** num_layers:
            raise ValueError(f"input {input_hw} is not divisible by 2^{num_layers}")
        self.input_hw = tuple(input_hw)
        self.num_tokens = num_tokens
        self.num_layers = num_layers
        self.num_resnet_blocks = num_resnet_blocks
        self.normalization = normalization
        self.codebook = nn.Embedding(num_tokens, codebook_dim, device=device)
        layers = []
        for i in range(num_layers):
            cin = channels if i == 0 else hidden_dim
            layers.append(nn.Sequential(
                nn.Conv2d(cin, hidden_dim, 4, stride=2, padding=1, device=device), nn.ReLU()))
        layers += [ResBlock(hidden_dim, device=device) for _ in range(num_resnet_blocks)]
        layers.append(nn.Conv2d(hidden_dim, num_tokens, 1, device=device))
        self.encoder = nn.Sequential(*layers)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Draw the weights as flax's defaults do: conv kernels lecun-normal
        (a normal truncated at 2 std, std 1/sqrt(fan_in)), conv biases zero,
        the codebook normal with std 1/sqrt(dim). PyTorch's default conv
        init, with its uniform biases, yields one token for every patch of
        a mostly empty event image."""
        for m in self.encoder.modules():
            if isinstance(m, nn.Conv2d):
                std = (1.0 / m.weight[0].numel()) ** 0.5 / 0.87962566103423978
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0, generator=generator)
                m.weight.copy_(w * std)
                m.bias.zero_()
        dim = self.codebook.weight.shape[1]
        self.codebook.weight.copy_(
            torch.randn(self.codebook.weight.shape, generator=generator) / dim ** 0.5)

    def _norm(self, images):
        if self.normalization is None:
            return images
        means = torch.as_tensor(self.normalization[0], dtype=images.dtype, device=images.device)
        stds = torch.as_tensor(self.normalization[1], dtype=images.dtype, device=images.device)
        return (images - means) / stds

    def encode_logits(self, img):
        """(B, H, W, C) -> (B, h, w, num_tokens) f32 logits."""
        x = self._norm(img.float()).permute(0, 3, 1, 2)
        with cudnn_full_f32():
            logits = self.encoder(x)
        return logits.permute(0, 2, 3, 1)

    def get_codebook_indices(self, img):
        """(B, H, W, C) -> (B, h*w) int64 argmax token ids
        (discrete_vae.py:242-247)."""
        logits = self.encode_logits(img)
        return torch.argmax(logits, dim=-1).reshape(logits.shape[0], -1)

    def load_reference_state_dict(self, sd: Dict[str, torch.Tensor]) -> list:
        """Load the ``encoder.*`` and ``codebook.*`` entries of a reference
        VAE state_dict, every one of them required; returns the names of the
        entries it ignored (the decoder's)."""
        mine = {k: v for k, v in sd.items() if k.startswith(("encoder.", "codebook."))}
        self.load_state_dict(mine, strict=True)
        return sorted(set(sd) - set(mine))
