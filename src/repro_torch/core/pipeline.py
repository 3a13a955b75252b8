"""Edge-detection pipeline pieces; this slice ports the colour conversion only."""
from __future__ import annotations

import torch

from repro_torch.kernels.tiling import luma

__all__ = ["rgb_to_gray"]


def rgb_to_gray(images: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8/float -> (..., H, W) float32 BT.601 grayscale,
    rounded exactly as the CUDA kernel computes it per pixel."""
    return luma(images)
