"""Dense oracle for the edge kernels: ``repro.kernels.ref`` in plain PyTorch.

The oracle is the *dense direct 2-D correlation* path of
``repro_torch.core.sobel`` (``variant="direct"``), a different code path
from the separable ladder the kernels run, so kernel-vs-oracle agreement
validates the whole RG-v1/v2 algebra, not just the plumbing.
"""
from __future__ import annotations

import torch

from repro_torch.core.filters import SobelParams
from repro_torch.core.sobel import magnitude, sobel_components

__all__ = ["sobel_ref", "sobel_components_ref"]


def sobel_components_ref(
    image: torch.Tensor,
    *,
    size: int = 5,
    directions: int = 4,
    params: SobelParams = SobelParams(),
    padding: str = "reflect",
):
    return sobel_components(
        image,
        size=size,
        directions=directions,
        variant="direct",
        params=params,
        padding=padding,
    )


def sobel_ref(
    image: torch.Tensor,
    *,
    size: int = 5,
    directions: int = 4,
    params: SobelParams = SobelParams(),
    padding: str = "reflect",
) -> torch.Tensor:
    """(..., H, W) -> (..., H, W) edge magnitude, direct dense math."""
    return magnitude(
        sobel_components_ref(
            image, size=size, directions=directions, params=params, padding=padding
        )
    )
