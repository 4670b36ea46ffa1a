"""RandAugment on uint8 NHWC batches, port of mem_tpu/ops/rand_augment.py
(the reference's EventRandAugment, mem/transforms.py:351-484: a torchvision
RandAugment clone with magnitude 20, 2 ops, zero fill, uint8 images).

All 14 ops run as batched torch ops with per-sample magnitudes. The
geometric ops are the reference's 1-D bilinear shift passes (rows, then
columns; the Paeth three-shear rotation), run in bf16 like the reference's
pass chain (rand_augment.py:90-124), and per-sample mode shares one
x -> y -> x pipeline over all geometric ops (``_geometric_round``,
:301-329). The photometric ops follow torchvision's ``_blend``/LUT
semantics; ``equalize`` builds its per-channel histograms with one
scatter-add (a bincount) instead of the reference's radix-16 one-hot
contractions, which exist because gathers are slow on a TPU.

The op, magnitude-bin and sign draws are not made here: the reference
draws them from ``jax.random`` keys on the device, whose bits torch cannot
reproduce. The port draws them on the host per sample
(data/device_pipeline.draw_train_aug) and the batch carries them, so the
CPU and the card augment identically.

The IMNET image path (data/device_pipeline.draw_image_aug) draws in timm's
``rand_augment_transform`` level mode (``timm_levels``, rand_augment.py:
332-341): each round's level is m + mstd * N(0, 1) clipped to [0, 10] and
mapped onto the 31-bin table as round(level / 10 * 30), half to even, and
the round applies only where its gate u < prob is on (one uniform a round).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from mem_tpu_torch.ops.consts import cached, constant

NUM_BINS = 31
NUM_OPS = 14
PHOTO_START = 6           # ops >= 6 are photometric
# the photometric-only pool of the segmentation pipeline: Identity and ops
# 6..13 (EventRandAugmentEvs(no_geometric_trafos=True), rand_augment.py:293)
PHOTOMETRIC_IDS = (0, 6, 7, 8, 9, 10, 11, 12, 13)
_LUMA = (0.299, 0.587, 0.114)
_PAD = 112                # static bound: max |offset| (translate <= 150/331*224 ~ 102)

OP_NAMES = [
    "Identity", "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate",
    "Brightness", "Color", "Contrast", "Sharpness", "Posterize", "Solarize",
    "AutoContrast", "Equalize",
]
SIGNED = (False, True, True, True, True, True, True, True, True, True,
          False, False, False, False)
_ID, _SHX, _SHY, _TRX, _TRY, _ROT = 0, 1, 2, 3, 4, 5


def _linspace_f32(start: float, stop: float, num: int) -> torch.Tensor:
    """jnp.linspace in f32: start + i * ((stop - start) / (num - 1)), the
    last value exactly ``stop``."""
    start_t = torch.tensor(start, dtype=torch.float32)
    delta = (torch.tensor(stop, dtype=torch.float32) - start_t) / (num - 1)
    body = start_t + torch.arange(num - 1, dtype=torch.float32) * delta
    return torch.cat([body, torch.tensor([stop], dtype=torch.float32)])


def magnitude_table(h: int, w: int, device=None) -> torch.Tensor:
    """(14, 31) f32 magnitude bins, rows in OP_NAMES order; unsigned and
    magnitude-free ops hold their own rows (rand_augment.py:45-65); made
    once per (h, w, device) (ops/consts.py)."""
    return cached(("magnitude_table", h, w), torch.float32, device or "cpu",
                  lambda: _magnitude_rows(h, w))


def _magnitude_rows(h: int, w: int) -> torch.Tensor:
    lin = _linspace_f32
    zeros = torch.zeros(NUM_BINS)
    posterize = 8 - torch.round(torch.arange(NUM_BINS, dtype=torch.float32)
                                / ((NUM_BINS - 1) / 4))
    rows = [zeros, lin(0.0, 0.3, NUM_BINS), lin(0.0, 0.3, NUM_BINS),
            lin(0.0, 150.0 / 331.0 * w, NUM_BINS), lin(0.0, 150.0 / 331.0 * h, NUM_BINS),
            lin(0.0, 30.0, NUM_BINS)] + [lin(0.0, 0.9, NUM_BINS)] * 4 + [
        posterize, lin(255.0, 0.0, NUM_BINS), zeros, zeros]
    return torch.stack(rows)


def signed_magnitudes(table, ops, bins, signs) -> torch.Tensor:
    """table[op, bin], negated for signed ops when sign == 1. ops, bins,
    signs: (B,) int tensors on the table's device."""
    mag = table[ops.long(), bins.long()]
    signed = constant(SIGNED, torch.bool, table.device)[ops.long()]
    return torch.where(signed & (signs == 1), -mag, mag)


# ---------------------------------------------------------------------------
# geometric ops as 1-D shift passes
# ---------------------------------------------------------------------------

def _shift_rows(img: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """out[b, i, j] = img[b, i, j + offsets[b, i]] with 1-D linear
    interpolation and zero fill; img (B, H, W, C), offsets (B, H) f32.
    The integer shift selects from the bf16 image padded by _PAD (+1 for
    the right neighbour), the fractional part lerps in f32."""
    B, H, W, C = img.shape
    padded = F.pad(img.to(torch.bfloat16), (0, 0, _PAD, _PAD + 1))
    n = torch.floor(offsets)
    f = (offsets - n)[..., None, None]
    m = torch.clamp(n.long() + _PAD, 0, 2 * _PAD)
    col = m[..., None] + torch.arange(W, device=img.device)
    # (B, H, W) indices broadcast over the channels, never materialized
    a = torch.gather(padded, 2, col[..., None].expand(B, H, W, C)).float()
    b2 = torch.gather(padded, 2, (col + 1)[..., None].expand(B, H, W, C)).float()
    return a * (1 - f) + b2 * f


def _shift_cols(img, offsets):
    return _shift_rows(img.transpose(1, 2), offsets).transpose(1, 2)


def _centered(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32, device=device) - (n - 1) / 2.0


_DEG2RAD = np.float32(np.pi / 180)


def _rot_shears(deg):
    th = deg * _DEG2RAD
    return torch.tan(th / 2.0), -torch.sin(th)


def _shear_x(img, mag):
    return _shift_rows(img, mag[:, None] * _centered(img.shape[1], img.device))


def _shear_y(img, mag):
    return _shift_cols(img, mag[:, None] * _centered(img.shape[2], img.device))


def _translate_x(img, mag):
    return _shift_rows(img, (-torch.trunc(mag))[:, None].expand(-1, img.shape[1]))


def _translate_y(img, mag):
    return _shift_cols(img, (-torch.trunc(mag))[:, None].expand(-1, img.shape[2]))


def _rotate(img, deg):
    t, s = _rot_shears(deg)
    ic = _centered(img.shape[1], img.device)
    jc = _centered(img.shape[2], img.device)
    out = _shift_rows(img, t[:, None] * ic)
    out = _shift_cols(out, s[:, None] * jc)
    return _shift_rows(out, t[:, None] * ic)


def geometric_round(img: torch.Tensor, ops: torch.Tensor, mag: torch.Tensor) -> torch.Tensor:
    """Whichever geometric op each sample's ``ops`` selects (identity for
    photometric indices) as one shared x-pass -> y-pass -> x-pass pipeline
    with op-dependent offsets (rand_augment.py:301-329)."""
    t_rot, s_rot = _rot_shears(mag)
    ic = _centered(img.shape[1], img.device)[None]
    jc = _centered(img.shape[2], img.device)[None]
    zero = torch.zeros_like(mag)
    is_rot = ops == _ROT

    def col(x):
        return x[:, None]

    x1 = col(torch.where(ops == _SHX, mag, zero)) * ic \
        + col(torch.where(is_rot, t_rot, zero)) * ic \
        + col(torch.where(ops == _TRX, -torch.trunc(mag), zero))
    y1 = col(torch.where(ops == _SHY, mag, zero)) * jc \
        + col(torch.where(is_rot, s_rot, zero)) * jc \
        + col(torch.where(ops == _TRY, -torch.trunc(mag), zero))
    x2 = col(torch.where(is_rot, t_rot, zero)) * ic
    img = _shift_rows(img, x1)
    img = _shift_cols(img, y1)
    return _shift_rows(img, x2)


# ---------------------------------------------------------------------------
# photometric ops (torchvision functional_tensor semantics on uint8-as-float)
# ---------------------------------------------------------------------------

def _bcast(mag):
    return mag[:, None, None, None]


def _blend(a, b, ratio):
    return torch.clamp(ratio * a + (1.0 - ratio) * b, 0.0, 255.0)


def _gray(img):
    luma = constant(_LUMA, torch.float32, img.device)
    return torch.round((img * luma).sum(dim=-1, keepdim=True))


def _brightness(img, mag):
    return _blend(img, torch.zeros_like(img), 1.0 + _bcast(mag))


def _color(img, mag):
    return _blend(img, _gray(img), 1.0 + _bcast(mag))


def _contrast(img, mag):
    mean = _gray(img).mean(dim=(1, 2, 3), keepdim=True)
    return _blend(img, mean.expand_as(img), 1.0 + _bcast(mag))


_SHARP = ((1.0, 1.0, 1.0), (1.0, 5.0, 1.0), (1.0, 1.0, 1.0))


def _sharpness(img, mag):
    """Blend with the [[1,1,1],[1,5,1],[1,1,1]]/13 blur (rounded, border
    pixels kept)."""
    return _blend(img, _blurred(img), 1.0 + _bcast(mag))


def _blurred(img):
    """Sharpness's degenerate image, as nine shifted f32 sums: no
    convolution, so no TF32."""
    B, H, W, C = img.shape
    padded = F.pad(img, (0, 0, 1, 1, 1, 1))
    blurred = torch.zeros_like(img)
    for i in range(3):
        for j in range(3):
            blurred = blurred + np.float32(_SHARP[i][j] / 13.0) * padded[:, i:i + H, j:j + W]
    blurred = torch.clamp(torch.round(blurred), 0, 255)
    interior = torch.zeros(H, W, 1, dtype=torch.bool, device=img.device)
    interior[1:H - 1, 1:W - 1] = True
    return torch.where(interior, blurred, img)


def _posterize(img, mag):
    bits = torch.clamp(mag.to(torch.int32), 0, 8)
    keep = (0xFF & ~((1 << (8 - bits)) - 1))[:, None, None, None]
    return (img.to(torch.uint8).to(torch.int32) & keep).float()


def _solarize(img, mag):
    return torch.where(img >= _bcast(mag), 255.0 - img, img)


def _autocontrast(img, _mag):
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    eq = hi == lo
    scale = 255.0 / torch.where(eq, torch.ones_like(hi), hi - lo)
    out = torch.clamp((img - lo) * scale, 0, 255)
    return torch.where(eq, img, out)


def _equalize(img, _mag):
    """Per-channel histogram equalisation with torchvision's LUT
    (rand_augment.py:226-266): a 256-bin histogram per (sample, channel),
    step = (count - count of the last non-empty bin) // 255, the LUT
    (cumsum + step // 2) // step shifted by one, identity where step == 0."""
    B, H, W, C = img.shape
    u8 = img.to(torch.int64).permute(0, 3, 1, 2).reshape(B * C, H * W)
    keys = u8 + 256 * torch.arange(B * C, device=img.device)[:, None]
    hist = torch.zeros(B * C * 256, dtype=torch.int64, device=img.device)
    hist = hist.scatter_add_(0, keys.reshape(-1), torch.ones_like(keys).reshape(-1))
    hist = hist.reshape(B * C, 256)
    last_idx = 255 - torch.argmax((hist > 0).flip(-1).to(torch.int32), dim=-1)
    last_val = torch.gather(hist, 1, last_idx[:, None])[:, 0]
    step = (hist.sum(dim=-1) - last_val) // 255
    lut = (torch.cumsum(hist, dim=-1) + (step // 2)[:, None]) // torch.clamp(step, min=1)[:, None]
    lut = torch.clamp(torch.cat([torch.zeros_like(lut[:, :1]), lut[:, :-1]], dim=-1), 0, 255)
    out = torch.gather(lut, 1, u8).reshape(B, C, H, W).permute(0, 2, 3, 1).float()
    same = (step == 0).reshape(B, 1, 1, C)
    return torch.where(same, img, out)


_OPS = [
    lambda img, mag: img,  # Identity
    _shear_x, _shear_y, _translate_x, _translate_y, _rotate,
    _brightness, _color, _contrast, _sharpness, _posterize, _solarize,
    _autocontrast, _equalize,
]


def apply_op(img: torch.Tensor, op: int, mag: torch.Tensor) -> torch.Tensor:
    """One op (a host int, shared by the batch) at per-sample magnitudes
    (B,) on (B, H, W, C) f32 pixel values (rand_augment.py:287)."""
    return _OPS[op](img, mag)


def select_op(img: torch.Tensor, op: torch.Tensor, mag: torch.Tensor, ops=range(NUM_OPS)):
    """:func:`apply_op` with the op a 0-d int tensor on the device (the
    reference's ``lax.switch`` on a traced index), bit for bit, so nothing
    is read back to the host and a CUDA graph replays the choice of each
    batch. ``ops``: the pool the op comes from. The ops share their work
    instead of each running on the batch: the five geometric ops are the
    x-pass -> y-pass -> x-pass of :func:`geometric_round` with op-selected
    offsets, each pass kept only where the op takes it (3 passes, not 7);
    Brightness, Color, Contrast and Sharpness are one blend with an
    op-selected degenerate image; Posterize, Solarize, AutoContrast and
    Equalize run and the one ``op`` names is kept."""
    pool = set(ops)
    out = img
    if pool & {_SHX, _SHY, _TRX, _TRY, _ROT}:
        out = _select_geometric(img, op, mag)
    blends = [j for j in (6, 7, 8, 9) if j in pool]
    if blends:
        gray = _gray(img)
        deg = {6: lambda: 0.0, 7: lambda: gray,
               8: lambda: gray.mean(dim=(1, 2, 3), keepdim=True),
               9: lambda: _blurred(img)}
        other = deg[blends[-1]]()
        for j in reversed(blends[:-1]):
            other = torch.where(op == j, deg[j](), other)
        is_blend = (op >= blends[0]) & (op <= blends[-1])
        out = torch.where(is_blend, _blend(img, other, 1.0 + _bcast(mag)), out)
    for j in (10, 11, 12, 13):
        if j in pool:
            out = torch.where(op == j, _OPS[j](img, mag), out)
    return out


def _select_geometric(img, op, mag):
    """The geometric op ``op`` names (the image itself for the others): the
    offsets of each pass are those the op's own function computes."""
    H, W = img.shape[1], img.shape[2]
    t, s = _rot_shears(mag)
    ic, jc = _centered(H, img.device), _centered(W, img.device)
    x_trans = (-torch.trunc(mag))[:, None]
    x1 = torch.where(op == _SHX, mag[:, None] * ic,
                     torch.where(op == _TRX, x_trans.expand(-1, H), t[:, None] * ic))
    y1 = torch.where(op == _SHY, mag[:, None] * jc,
                     torch.where(op == _TRY, x_trans.expand(-1, W), s[:, None] * jc))
    rows = (op == _SHX) | (op == _TRX) | (op == _ROT)
    cols = (op == _SHY) | (op == _TRY) | (op == _ROT)
    out = torch.where(rows, _shift_rows(img, x1), img)
    out = torch.where(cols, _shift_cols(out, y1), out)
    return torch.where(op == _ROT, _shift_rows(out, t[:, None] * ic), out)


def photometric_select(img: torch.Tensor, ops: torch.Tensor, mag: torch.Tensor) -> torch.Tensor:
    """Each sample's photometric op (identity for geometric indices), the
    reference's per-sample ``lax.switch`` (rand_augment.py:373-376): every
    op runs on the batch and each sample keeps its own, so no op choice is
    read back to the host."""
    out = img
    for op in range(PHOTO_START, NUM_OPS):
        out = torch.where((ops == op)[:, None, None, None], _OPS[op](img, mag), out)
    return out


def rand_augment_batch(imgs_u8: torch.Tensor, ops, bins, signs, batch_ops=None,
                       geometric: bool = True, gate=None) -> torch.Tensor:
    """RandAugment over a (B, H, W, C) uint8 batch with host-drawn
    (B, num_ops) op indices, magnitude bins and signs (rand_augment.py:
    344-435). ``batch_ops``: None for per-sample op choice (the shared
    geometric pipeline, then the photometric switch), or the (num_ops,) host
    ints of batch-level op choice (``--rand_aug_batch_ops 1``: each round
    applies one op to the whole batch; held in a device tensor, as a
    chain's block holds them (train/chain.py), each round's op is chosen on
    the device by :func:`select_op`, with the host branch's result). ``geometric=False`` is the
    segmentation pipeline's photometric-only mode: the ops come from
    PHOTOMETRIC_IDS and no geometric round runs (rand_augment.py:377-378).
    ``gate``: None, or the (B, num_ops) bool apply gates of timm's mode: where
    a sample's gate is off, its round leaves the image as it was
    (rand_augment.py:379-382, 430-431). Returns uint8, clipped and
    truncated."""
    B, H, W, _ = imgs_u8.shape
    table = magnitude_table(H, W, device=imgs_u8.device)
    img = imgs_u8.float()
    for r in range(ops.shape[1]):
        mag = signed_magnitudes(table, ops[:, r], bins[:, r], signs[:, r])
        if torch.is_tensor(batch_ops):
            new = select_op(img, batch_ops[r], mag,
                            range(NUM_OPS) if geometric else PHOTOMETRIC_IDS)
        elif batch_ops is not None:
            new = apply_op(img, int(batch_ops[r]), mag)
        else:
            new = geometric_round(img, ops[:, r], mag) if geometric else img
            new = photometric_select(new, ops[:, r], mag)
        img = new if gate is None else torch.where(gate[:, r, None, None, None], new, img)
    return torch.clamp(img, 0, 255).to(torch.uint8)


def timm_bin(magnitude: int, mstd: float, rng) -> int:
    """timm's level of one round mapped onto the 31-bin table
    (rand_augment.py:332-341), in f32 as the reference computes it: m +
    mstd * N(0, 1) (no normal draw at mstd 0), clipped to [0, 10], then
    round(level / 10 * 30) half to even."""
    lvl = np.float32(magnitude)
    if mstd > 0:
        lvl = np.float32(lvl + np.float32(mstd) * np.float32(rng.standard_normal()))
    lvl = np.clip(lvl, np.float32(0.0), np.float32(10.0))
    return int(np.round(lvl / np.float32(10.0) * np.float32(NUM_BINS - 1)))


def draw_rand_augment(rngs, num_ops: int, magnitude: int, batch_rng=None,
                      geometric: bool = True, timm_levels: bool = False, mstd: float = 0.0,
                      prob: float = 1.0):
    """Host draws for ``rand_augment_batch``: per sample and round an op in
    [0, 14) (with ``geometric=False`` one of the 9 PHOTOMETRIC_IDS), a bin
    in [0, magnitude] (with ``timm_levels`` :func:`timm_bin` instead), a sign
    in {0, 1} and, with ``prob`` < 1, the apply gate u < prob
    (rand_augment.py:354-382). With ``batch_rng`` the op of each round is
    drawn once from it and shared by the batch. Returns (ops, bins, signs)
    int32 (B, num_ops), the (B, num_ops) bool gate (all on at prob 1, with
    no draw) and the (num_ops,) batch ops or None."""
    pool = np.arange(NUM_OPS) if geometric else np.array(PHOTOMETRIC_IDS)
    B = len(rngs)
    ops = np.zeros((B, num_ops), np.int32)
    bins = np.zeros((B, num_ops), np.int32)
    signs = np.zeros((B, num_ops), np.int32)
    gate = np.ones((B, num_ops), bool)
    for b, rng in enumerate(rngs):
        for r in range(num_ops):
            ops[b, r] = pool[rng.integers(0, len(pool))]
            bins[b, r] = (timm_bin(magnitude, mstd, rng) if timm_levels
                          else rng.integers(0, magnitude + 1))
            signs[b, r] = rng.integers(0, 2)
            if prob < 1.0:
                gate[b, r] = rng.random() < prob
    batch_ops = None
    if batch_rng is not None:
        batch_ops = pool[batch_rng.integers(0, len(pool), size=num_ops)].astype(np.int32)
        ops[:] = batch_ops[None, :]
    return ops, bins, signs, gate, batch_ops
