"""The discrete-VAE event tokenizer (DALL-E style, Gumbel-softmax over a
codebook) and the non-overlapping ``TorchConvTranspose`` the segmentation
necks use; port of mem_tpu/models/discrete_vae.py (the reference's
eventvae/vae/vae_model.py:45-213 and, for ``LegacyDiscreteVAE``,
mem/modeling_discrete_vae.py:75-196).

``DiscreteVAE``: ``num_layers`` stride-2 4x4 convs with ReLU,
``num_resnet_blocks`` ResBlocks (conv3x3-ReLU-conv3x3-ReLU-conv1x1 + skip)
and a 1x1 head to ``num_tokens`` logits; ``get_codebook_indices`` is the
argmax over them. The decoder mirrors it: a 1x1 conv from the codebook
width (when there are ResBlocks), the ResBlocks, ``num_layers``
ConvTranspose2d(4, 2, 1) with ReLU and a 1x1 conv to the channels. The
modules are laid out as the reference's ``nn.Sequential`` so the reference
VAE state_dict (``codebook.weight``, ``encoder.{i}.0.*``,
``encoder.{L+j}.net.*``, ``encoder.{L+R}.*``, ``decoder.0.*``,
``decoder.{1+j}.net.*``, ``decoder.{1+R+i}.0.*``, ``decoder.{1+R+L}.*``;
the schema mem_tpu/utils/torch_import.py ``import_vae_state_dict`` reads)
loads with ``load_state_dict(strict=True)``.

The training forward (``forward``) draws Gumbel noise from a
``torch.Generator`` (or takes a pre-drawn array, as the reference's hook
does: torch cannot reproduce ``jax.random.gumbel``'s bits), takes the
tempered softmax, decodes the soft codes and returns the reconstruction
loss plus the KL to the uniform prior, with the reference's "batchmean"
quirk: the KL sum is not divided by the batch size.

Compute dtype as flax's ``dtype=``: the parameters stay f32, every
convolution runs on its input and its weight and bias cast to ``dtype``,
the softmax, the KL and the losses run in f32. In f32 the convolutions run
with cuDNN's TF32 off (``cudnn_full_f32``), forward and backward: the
pretraining CLI builds its frozen tokenizer in f32
(run_mem_pretraining.py:262-271), and PyTorch's default would run f32
convolutions in TF32 on the card and change the labels.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mem_tpu_torch.ops.consts import constant


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype: the f32 weight and bias are cast
    to it (flax's ``dtype=``)."""

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` in its input's dtype. ConvTranspose2d(4, 2, 1)
    is what the reference's ``TorchConvTranspose`` replicates with an
    input-dilated convolution and a flipped kernel (discrete_vae.py:71-144);
    its custom VJP and sub-pixel form are TPU scheduling choices."""

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                                  self.stride, self.padding)


class ResBlock(nn.Module):
    def __init__(self, chan: int, device=None):
        super().__init__()
        self.net = nn.Sequential(
            Conv2d(chan, chan, 3, padding=1, device=device), nn.ReLU(),
            Conv2d(chan, chan, 3, padding=1, device=device), nn.ReLU(),
            Conv2d(chan, chan, 1, device=device))

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
    kernel-4 stride-2 padding-1 case is :class:`ConvTranspose2d` on NCHW."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 2, stride: int = 2,
                 padding: int = 0, dtype=torch.float32, device=None):
        super().__init__()
        if kernel_size != stride or padding != 0:
            raise NotImplementedError(
                f"TorchConvTranspose(kernel {kernel_size}, stride {stride}, padding "
                f"{padding}): only kernel == stride, padding 0; the VAE decoder's 4/2/1 "
                f"case is models.discrete_vae.ConvTranspose2d")
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


def _down(cin: int, cout: int, device) -> nn.Sequential:
    return nn.Sequential(Conv2d(cin, cout, 4, stride=2, padding=1, device=device), nn.ReLU())


def _up(cin: int, cout: int, device) -> nn.Sequential:
    return nn.Sequential(ConvTranspose2d(cin, cout, 4, stride=2, padding=1, device=device),
                         nn.ReLU())


def gumbel_like(shape, device, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u ~ U[tiny, 1) in f32 (the
    distribution of ``jax.random.gumbel``; the bits are torch's)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _kl_to_uniform(logits) -> torch.Tensor:
    """KL(q || uniform) summed over every position of the batch: the
    reference's ``kl_div(..., reduction='batchmean')`` divides by the
    broadcast 1-element input's first dimension, i.e. by 1."""
    log_qy = torch.log_softmax(logits.float(), dim=-1)
    return (log_qy.exp() * (log_qy - math.log(1.0 / logits.shape[-1]))).sum()


def _smooth_l1(target, rec):
    d = (target - rec).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5).mean()


def _init_convs(modules, generator: torch.Generator) -> None:
    for m in modules:
        if isinstance(m, nn.ConvTranspose2d):
            # flax variance_scaling(1/3, fan_in, uniform) over the output
            # features: U(+-1/sqrt(O k k)) (discrete_vae.py:125)
            lim = (1.0 / m.weight[0].numel()) ** 0.5
            m.weight.copy_(torch.rand(m.weight.shape, generator=generator) * 2 * lim - lim)
            m.bias.zero_()
        elif isinstance(m, nn.Conv2d):
            std = (1.0 / m.weight[0].numel()) ** 0.5 / 0.87962566103423978
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0, generator=generator)
            m.weight.copy_(w * std)
            m.bias.zero_()


class _GumbelVAE(nn.Module):
    """What both VAEs share: the Gumbel-softmax training forward over
    ``encode_logits`` and a decoder of the soft codes."""

    def _soft_codes(self, logits, temperature, generator, gumbel_noise):
        if gumbel_noise is None:
            gumbel_noise = gumbel_like(logits.shape, logits.device, generator)
        soft = torch.softmax((logits.float() + gumbel_noise.float()) / temperature, dim=-1)
        if self.straight_through:
            hard = torch.zeros_like(soft).scatter_(-1, soft.argmax(dim=-1, keepdim=True), 1.0)
            soft = hard + soft - soft.detach()
        return soft

    def _embed_soft(self, soft):
        return torch.einsum("bhwn,nd->bhwd", soft.to(self.dtype),
                            self.codebook.weight.to(self.dtype))

    def _train_loss(self, target, img, temperature, generator, return_recons, gumbel_noise):
        logits = self.encode_logits(img)
        soft = self._soft_codes(logits, temperature, generator, gumbel_noise)
        out = self._decode(self._embed_soft(soft))
        recon = self._recon_loss(target.float(), out.float())
        loss = recon + self.kl_div_loss_weight * _kl_to_uniform(logits)
        return (loss, out) if return_recons else loss


class DiscreteVAE(_GumbelVAE):
    """The event VAE (discrete_vae.py:163). Images are NHWC, as in the
    reference; the convolutions run on NCHW views of them."""

    def __init__(self, input_hw: Tuple[int, int] = (224, 224), num_tokens: int = 8192,
                 codebook_dim: int = 32, num_layers: int = 4, num_resnet_blocks: int = 3,
                 hidden_dim: int = 384, channels: int = 3, loss_type: str = "mse",
                 straight_through: bool = False, kl_div_loss_weight: float = 1e-10,
                 normalization: Optional[Tuple[Sequence[float], Sequence[float]]] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        if input_hw[0] % 2 ** num_layers or input_hw[1] % 2 ** num_layers:
            raise ValueError(f"input {input_hw} is not divisible by 2^{num_layers}")
        if loss_type not in ("mse", "smooth_l1", "cosine"):
            raise ValueError(f"loss_type {loss_type!r}")
        self.input_hw = tuple(input_hw)
        self.num_tokens = num_tokens
        self.codebook_dim = codebook_dim
        self.num_layers = num_layers
        self.num_resnet_blocks = num_resnet_blocks
        self.loss_type = loss_type
        self.straight_through = straight_through
        self.kl_div_loss_weight = kl_div_loss_weight
        self.normalization = normalization
        self.dtype = dtype
        self.codebook = nn.Embedding(num_tokens, codebook_dim, device=device)
        R = num_resnet_blocks
        enc = [_down(channels if i == 0 else hidden_dim, hidden_dim, device)
               for i in range(num_layers)]
        enc += [ResBlock(hidden_dim, device=device) for _ in range(R)]
        enc.append(Conv2d(hidden_dim, num_tokens, 1, device=device))
        self.encoder = nn.Sequential(*enc)
        dec = [Conv2d(codebook_dim, hidden_dim, 1, device=device)] if R else []
        dec += [ResBlock(hidden_dim, device=device) for _ in range(R)]
        dec += [_up(hidden_dim if (R or i) else codebook_dim, hidden_dim, device)
                for i in range(num_layers)]
        dec.append(Conv2d(hidden_dim, channels, 1, device=device))
        self.decoder = nn.Sequential(*dec)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Draw the weights as flax's defaults do: conv kernels lecun-normal
        (a normal truncated at 2 std, std 1/sqrt(fan_in)), the decoder's
        ConvTranspose2d kernels U(+-1/sqrt(fan_in)) with fan_in over the
        output features, biases zero, the codebook normal with std
        1/sqrt(dim). PyTorch's default conv init, with its uniform biases,
        yields one token for every patch of a mostly empty event image. The
        encoder is drawn first, then the codebook, then the decoder."""
        _init_convs(self.encoder.modules(), generator)
        dim = self.codebook.weight.shape[1]
        self.codebook.weight.copy_(
            torch.randn(self.codebook.weight.shape, generator=generator) / dim ** 0.5)
        _init_convs(self.decoder.modules(), generator)

    def _norm(self, images):
        if self.normalization is None:
            return images
        means = constant(tuple(self.normalization[0]), images.dtype, images.device)
        stds = constant(tuple(self.normalization[1]), images.dtype, images.device)
        return (images - means) / stds

    def encode_logits(self, img):
        """(B, H, W, C) -> (B, h, w, num_tokens) logits in the compute dtype."""
        x = _nchw(self._norm(img.float()).to(self.dtype))
        with cudnn_full_f32():
            return _nhwc(self.encoder(x))

    def _decode(self, x):
        """(B, h, w, codebook_dim) -> (B, H, W, C) in the compute dtype."""
        with cudnn_full_f32():
            return _nhwc(self.decoder(_nchw(x.to(self.dtype))))

    def get_codebook_indices(self, img):
        """(B, H, W, C) -> (B, h*w) int64 argmax token ids
        (discrete_vae.py:242-247)."""
        logits = self.encode_logits(img)
        return torch.argmax(logits, dim=-1).reshape(logits.shape[0], -1)

    def decode_indices(self, ids):
        """(B, n) token ids -> (B, H, W, C) (discrete_vae.py:249-262)."""
        h = self.input_hw[0] // 2 ** self.num_layers
        w = self.input_hw[1] // 2 ** self.num_layers
        return self._decode(self.codebook(ids).reshape(ids.shape[0], h, w, self.codebook_dim))

    def _recon_loss(self, target, rec):
        if self.loss_type == "mse":
            return ((target - rec) ** 2).mean()
        if self.loss_type == "smooth_l1":
            return _smooth_l1(target, rec)
        tn = target / (torch.linalg.vector_norm(target, dim=-1, keepdim=True) + 1e-9)
        rn = rec / (torch.linalg.vector_norm(rec, dim=-1, keepdim=True) + 1e-9)
        return (1.0 - (tn * rn).sum(dim=-1)).mean()

    def forward(self, img, temperature: float = 0.9, generator: Optional[torch.Generator] = None,
                return_recons: bool = False, gumbel_noise: Optional[torch.Tensor] = None):
        """Training forward -> the loss (and the reconstruction, in the
        normalized space, with ``return_recons``). ``gumbel_noise``: a
        pre-drawn (B, h, w, num_tokens) array; otherwise the noise is drawn
        from ``generator``."""
        return self._train_loss(self._norm(img.float()), img, temperature, generator,
                                return_recons, gumbel_noise)


class LegacyDiscreteVAE(_GumbelVAE):
    """The lucidrains-style square-image VAE (discrete_vae.py:317), dead code
    in the reference but the tokenizer behind its ``--discrete_vae_type``
    slot. Against :class:`DiscreteVAE`: a ResBlock after every stride-2
    conv and deconv (the reference's layout ``[Seq(Conv, ReLU), ResBlock] *
    L + [Conv1x1]``, decoder ``[Seq(ConvT, ReLU), ResBlock] * L +
    [Conv1x1]``, the first deconv from the codebook width), no input
    normalization, mse or smooth-L1 only, ``get_codebook_indices`` on the
    (B, h, w) grid, ``decode_indices`` on the square grid int(sqrt(n)), and
    ``get_image_tokens_size`` = image_size // 8 whatever ``num_layers``."""

    def __init__(self, image_size: int = 256, num_tokens: int = 512, codebook_dim: int = 512,
                 num_layers: int = 3, hidden_dim: int = 64, channels: int = 3,
                 smooth_l1_loss: bool = False, temperature: float = 0.9,
                 straight_through: bool = False, kl_div_loss_weight: float = 0.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        if num_layers < 1:
            raise ValueError("number of layers must be >= 1")
        self.image_size = image_size
        self.num_tokens = num_tokens
        self.codebook_dim = codebook_dim
        self.smooth_l1_loss = smooth_l1_loss
        self.temperature = temperature
        self.straight_through = straight_through
        self.kl_div_loss_weight = kl_div_loss_weight
        self.dtype = dtype
        self.codebook = nn.Embedding(num_tokens, codebook_dim, device=device)
        enc, dec = [], []
        for i in range(num_layers):
            enc += [_down(channels if i == 0 else hidden_dim, hidden_dim, device),
                    ResBlock(hidden_dim, device=device)]
            dec += [_up(codebook_dim if i == 0 else hidden_dim, hidden_dim, device),
                    ResBlock(hidden_dim, device=device)]
        enc.append(Conv2d(hidden_dim, num_tokens, 1, device=device))
        dec.append(Conv2d(hidden_dim, channels, 1, device=device))
        self.encoder = nn.Sequential(*enc)
        self.decoder = nn.Sequential(*dec)

    def get_image_size(self):
        return self.image_size

    def get_image_tokens_size(self):
        return self.image_size // 8

    def encode_logits(self, img):
        """(B, H, W, C) -> (B, h, w, num_tokens) logits in the compute dtype."""
        with cudnn_full_f32():
            return _nhwc(self.encoder(_nchw(img.to(self.dtype))))

    def _decode(self, x):
        with cudnn_full_f32():
            return _nhwc(self.decoder(_nchw(x.to(self.dtype))))

    def get_codebook_indices(self, img):
        """(B, H, W, C) -> (B, h, w) argmax ids, unflattened."""
        return torch.argmax(self.encode_logits(img), dim=-1)

    def get_codebook_probs(self, img):
        """(B, H, W, C) -> (B, h, w, num_tokens) f32 softmax probabilities."""
        return torch.softmax(self.encode_logits(img).float(), dim=-1)

    def decode_indices(self, ids):
        """(B, n) flat ids on the square grid int(sqrt(n)) -> (B, H, W, C)."""
        b, n = ids.shape
        side = int(n ** 0.5)
        return self._decode(self.codebook(ids).reshape(b, side, side, self.codebook_dim))

    def _embed_soft(self, soft):
        # the codes in f32, then cast (modeling_discrete_vae.py:173-176)
        return torch.einsum("bhwn,nd->bhwd", soft, self.codebook.weight)

    def _recon_loss(self, target, rec):
        return _smooth_l1(target, rec) if self.smooth_l1_loss else ((target - rec) ** 2).mean()

    def forward(self, img, temp: Optional[float] = None,
                generator: Optional[torch.Generator] = None, return_recons: bool = False,
                gumbel_noise: Optional[torch.Tensor] = None):
        """Training forward -> the loss (modeling_discrete_vae.py:156-196)."""
        if img.shape[1] != self.image_size or img.shape[2] != self.image_size:
            raise ValueError(f"input must have the correct image size {self.image_size}")
        return self._train_loss(img, img, self.temperature if temp is None else temp,
                                generator, return_recons, gumbel_noise)
