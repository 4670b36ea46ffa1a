"""Visual diagnostics: preprocessed-sample dumps (the reference seg
pipeline's SaveToDisk op, EventDataset.py:682-708), colourised annotations
(tools/plot_anns.py), and the VAE reconstruction panels and BEiT mask
overlays that ``train_vae`` and ``run_mem_pretraining --dump_recon_dir``
write (the reference's wandb image dumps, engine_for_pretraining.py:167-201,
train_vae.py:344).

The port's own copy of what those need from mem_tpu/utils/visualize.py.
All functions return or save HWC uint8 numpy images and take NHWC float
event images, (N,) patch masks and (H, W) label maps.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def _to_u8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, dtype=np.float32)
    lo, hi = img.min(), img.max()
    if hi > lo:
        img = (img - lo) / (hi - lo)
    return (img * 255).astype(np.uint8)


def event_image_to_rgb(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) event histogram -> display RGB: positive counts red,
    negative counts blue, timesurface green (the natural reading of the
    channel convention)."""
    img = np.asarray(img, dtype=np.float32)
    rgb = np.stack([img[..., 0], img[..., 1], img[..., 2]], axis=-1)
    return _to_u8(rgb)


def grid(images: Sequence[np.ndarray], cols: int = 4, pad: int = 2) -> np.ndarray:
    """Tile HWC uint8 images into a grid."""
    images = [np.asarray(im) for im in images]
    h, w, c = images[0].shape
    rows = -(-len(images) // cols)
    out = np.zeros((rows * (h + pad) - pad, cols * (w + pad) - pad, c), np.uint8)
    for i, im in enumerate(images):
        r, cc = divmod(i, cols)
        out[r * (h + pad) : r * (h + pad) + h, cc * (w + pad) : cc * (w + pad) + w] = im
    return out


def mask_overlay(img: np.ndarray, bool_mask: np.ndarray, patch: int = 16) -> np.ndarray:
    """Dim the masked patches of an event image. ``bool_mask`` is (N,) over
    the (H / patch, W / patch) grid."""
    rgb = event_image_to_rgb(img).astype(np.float32)
    H, W, _ = rgb.shape
    m = np.asarray(bool_mask, bool).reshape(H // patch, W // patch)
    rgb[np.kron(m, np.ones((patch, patch), bool))] *= 0.25
    return rgb.astype(np.uint8)


def reconstruction_panel(originals: np.ndarray, reconstructions: np.ndarray,
                         cols: int = 4) -> np.ndarray:
    """Original / reconstruction pairs side by side (the VAE eval dumps)."""
    imgs = []
    for o, r in zip(originals, reconstructions):
        imgs += [event_image_to_rgb(o), event_image_to_rgb(r)]
    return grid(imgs, cols=cols)


# distinct color palette for label maps (Cityscapes-like hues)
_PALETTE = np.array(
    [
        [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
        [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
        [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
        [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
        [0, 0, 230], [119, 11, 32],
    ],
    dtype=np.uint8,
)


def colorize_labels(labels: np.ndarray, ignore_index: int = 255) -> np.ndarray:
    """(H, W) int label map -> RGB (plot_anns.py role); ignore -> black."""
    labels = np.asarray(labels)
    out = np.zeros((*labels.shape, 3), np.uint8)
    valid = labels != ignore_index
    out[valid] = _PALETTE[labels[valid] % len(_PALETTE)]
    return out


def save_png(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(img).save(path)


def dump_sample_panels(out_dir: str, images: np.ndarray, labels: np.ndarray | None = None,
                       start: int = 0) -> int:
    """Preprocessed-sample dumps. With ``labels`` (the seg pipeline, the role
    of its SaveToDisk op, EventDataset.py:682-708: img + gt_semantic_seg
    PNGs): one image | colorized annotation panel per sample. Without (the
    classification finetune's epoch-0 debug dump,
    engine_for_finetuning.py:60-74): the image alone. ``images`` is
    (B, H, W, 3) float, ``labels`` (B, H, W) int. Returns the next sample
    index."""
    os.makedirs(out_dir, exist_ok=True)
    images = np.asarray(images)
    for i in range(images.shape[0]):
        panel = event_image_to_rgb(images[i])
        if labels is not None:
            panel = grid([panel, colorize_labels(np.asarray(labels)[i])], cols=2)
        save_png(os.path.join(out_dir, f"{start + i:05d}.png"), panel)
    return start + images.shape[0]
