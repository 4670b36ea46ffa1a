"""Masked-position generators for BEiT-style pretraining: mem_tpu/ops/masking.py
as it is (pure numpy; the port cannot import it, because mem_tpu/ops/__init__.py
imports jax).

Host-side numpy: the BEiT block-masking algorithm is an inherently sequential
rejection loop over O(196) ints per sample — the wrong shape for a TPU and
microscopic on a host core, so it stays in the input pipeline (matching where
the reference runs it: inside dataloader workers, mem/datasets.py:68-73).

Both generators take an explicit ``np.random.Generator`` for determinism.
Semantics match mem/masking_generator.py:18-116, including the reference's
off-by-one in the random-location variant (``np.arange(max_idx)`` excludes the
last patch index — preserved for parity, flagged in the docstring).
"""
from __future__ import annotations

import math

import numpy as np


class BlockMaskingGenerator:
    """BEiT block masking (reference: MaskingGenerator, masking_generator.py:18-81).

    Repeatedly samples log-uniform-aspect rectangles of
    ``min_num_patches..max_num_patches`` patches (10 attempts per round) until
    ``num_masking_patches`` are covered. Returns an (H, W) int mask with
    *at least* ``num_masking_patches`` ones in the typical case (the loop can
    overshoot within a block and can stall out early if no rectangle fits).
    """

    def __init__(
        self,
        input_size,
        num_masking_patches: int,
        min_num_patches: int = 4,
        max_num_patches: int | None = None,
        min_aspect: float = 0.3,
        max_aspect: float | None = None,
    ):
        if not isinstance(input_size, tuple):
            input_size = (input_size,) * 2
        self.height, self.width = input_size
        self.num_patches = self.height * self.width
        self.num_masking_patches = num_masking_patches
        self.min_num_patches = min_num_patches
        self.max_num_patches = (
            num_masking_patches if max_num_patches is None else max_num_patches
        )
        max_aspect = max_aspect or 1 / min_aspect
        self.log_aspect_ratio = (math.log(min_aspect), math.log(max_aspect))

    def _mask(self, mask: np.ndarray, max_mask_patches: int, rng: np.random.Generator) -> int:
        delta = 0
        for _ in range(10):
            # python's random.uniform (used by the reference) tolerates
            # reversed bounds when fewer than min_num_patches remain
            lo, hi = sorted((self.min_num_patches, max_mask_patches))
            target_area = rng.uniform(lo, hi)
            aspect_ratio = math.exp(rng.uniform(*self.log_aspect_ratio))
            h = int(round(math.sqrt(target_area * aspect_ratio)))
            w = int(round(math.sqrt(target_area / aspect_ratio)))
            if w < self.width and h < self.height:
                top = int(rng.integers(0, self.height - h + 1))
                left = int(rng.integers(0, self.width - w + 1))
                num_masked = int(mask[top : top + h, left : left + w].sum())
                if 0 < h * w - num_masked <= max_mask_patches:
                    region = mask[top : top + h, left : left + w]
                    delta = int((region == 0).sum())
                    region[:] = 1
                if delta > 0:
                    break
        return delta

    def __call__(self, rng: np.random.Generator) -> np.ndarray:
        mask = np.zeros((self.height, self.width), dtype=np.int64)
        mask_count = 0
        while mask_count < self.num_masking_patches:
            max_mask_patches = min(
                self.num_masking_patches - mask_count, self.max_num_patches
            )
            delta = self._mask(mask, max_mask_patches, rng)
            if delta == 0:
                break
            mask_count += delta
        return mask


class RandomMaskingGenerator:
    """Uniform random masking without replacement.

    Reference: MaskingGeneratorRandomLocation, masking_generator.py:85-116.
    Preserves the reference's quirk of sampling from ``arange(H*W - 1)`` — the
    last patch index is never masked.
    """

    def __init__(self, input_size, num_masking_patches: int):
        if not isinstance(input_size, tuple):
            input_size = (input_size,) * 2
        self.height, self.width = input_size
        self.num_patches = self.height * self.width
        self.num_masking_patches = num_masking_patches
        assert self.num_masking_patches < self.num_patches

    def __call__(self, rng: np.random.Generator) -> np.ndarray:
        mask = np.zeros(self.num_patches, dtype=np.int64)
        max_idx = self.num_patches - 1
        idxs = rng.choice(max_idx, size=self.num_masking_patches, replace=False)
        mask[idxs] = 1
        return mask.reshape(self.height, self.width)


def make_mask_generator(masking: str, window_size, num_masking_patches: int,
                        min_num_patches: int = 4, max_num_patches: int | None = None):
    """Factory matching the config switch ``masking = block|random``
    (mem/datasets.py:55-66)."""
    if masking == "block":
        return BlockMaskingGenerator(
            window_size, num_masking_patches,
            min_num_patches=min_num_patches, max_num_patches=max_num_patches,
        )
    if masking == "random":
        return RandomMaskingGenerator(window_size, num_masking_patches)
    raise ValueError(f"unknown masking scheme: {masking!r}")
