"""Mask providers: the callable contract the pipeline composites under, and
two providers that need no weights.

Counterpart of `gaussctrl_tpu/seg/masker.py`.
"""

from __future__ import annotations

from typing import Protocol

import torch


class MaskProvider(Protocol):
    def __call__(self, images: torch.Tensor, text: str) -> torch.Tensor:
        """images [V,H,W,3] in [0,1] -> masks [V,H,W,1] in [0,1]."""
        ...


class NullMasker:
    """All-ones masks: edit everywhere (the path without `langsam_obj`)."""

    def __call__(self, images: torch.Tensor, text: str) -> torch.Tensor:
        return torch.ones(images.shape[:3] + (1,), dtype=images.dtype,
                          device=images.device)


class ThresholdMasker:
    """Luminance threshold for tests: 'dark' keeps the dark pixels, any other
    text the bright ones."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold

    def __call__(self, images: torch.Tensor, text: str) -> torch.Tensor:
        lum = images.mean(dim=-1, keepdim=True)
        if text == "dark":
            return (lum < self.threshold).to(images.dtype)
        return (lum >= self.threshold).to(images.dtype)
