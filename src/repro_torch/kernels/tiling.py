"""Boundary rules, ragged-tile masks and luma, shared by the kernel's plain version.

The part of ``repro.kernels.tiling`` that is arithmetic rather than Pallas
window geometry: the CUDA kernel (``csrc/edge.cu``) applies the same index
maps while it stages its halo window in shared memory, and the plain
PyTorch version builds the boundary-extended image from them.
``window_shape`` and ``window_origin`` keep the reference's clamped
window (with the off-TPU alignment): the streaming change test reaches that
far, and K2 (``csrc/edge_pipelined.cu``) copies exactly that window into
its ring. ``halo_amplification``/``window_amplification`` are the tuner's
cost columns.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = [
    "PAD_MODES",
    "LUMA_WEIGHTS",
    "window_radius",
    "ALIGN_INTERPRET",
    "window_shape",
    "window_origin",
    "reflect_index",
    "boundary_index",
    "valid_mask",
    "luma",
    "halo_amplification",
    "window_amplification",
]

PAD_MODES = ("reflect", "edge", "zero")

# BT.601 luma weights (OpenCV cvtColor convention); the same constants as
# repro_torch.core.pipeline.rgb_to_gray and the CUDA kernel.
LUMA_WEIGHTS = (0.299, 0.587, 0.114)


def window_radius(radius: int, nms: bool = False) -> int:
    """Input-window reach of a fused kernel step: the stencil radius, plus
    the 1-px neighbourhood NMS compares against."""
    return radius + (1 if nms else 0)


# The reference's window alignment off the TPU. The CUDA kernels stage their
# windows element by element, so no alignment applies.
ALIGN_INTERPRET = (1, 1)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def window_shape(h: int, w: int, block_h: int, block_w: int, r: int, *,
                 align: Tuple[int, int] = ALIGN_INTERPRET) -> Tuple[int, int]:
    """(tile_h, tile_w) of the clamped input window of one output tile:
    ``block + 2r`` rounded up to ``align``, clamped to the image. The
    streaming change test reaches as far as this window."""
    th = min(_round_up(block_h + 2 * r, align[0]), h)
    tw = min(_round_up(block_w + 2 * r, align[1]), w)
    return th, tw


def window_origin(k: int, j: int, h: int, w: int, block_h: int, block_w: int, r: int,
                  tile_h: int, tile_w: int) -> Tuple[int, int]:
    """Clamped ``(row0, col0)`` of tile ``(k, j)``'s ``tile_h x tile_w``
    input window (:func:`window_shape`): the window starts ``r`` before the
    tile and is shifted back inside the image at its edges. K2 copies its
    ring windows from these origins (``csrc/edge_pipelined.cu``)."""
    row0 = min(max(k * block_h - r, 0), h - tile_h)
    col0 = min(max(j * block_w - r, 0), w - tile_w)
    return row0, col0


def reflect_index(g: torch.Tensor, n: int) -> torch.Tensor:
    """numpy ``mode='reflect'`` source index for any overhang.

    The padded sequence is mirror-periodic with period ``2(n - 1)``; a
    single-pixel axis reflects to itself.
    """
    if n == 1:
        return torch.zeros_like(g)
    period = 2 * (n - 1)
    m = torch.remainder(g, period)          # floored: non-negative for g < 0
    return torch.where(m < n, m, period - m)


def boundary_index(g: torch.Tensor, n: int, padding: str) -> torch.Tensor:
    """Source coordinate in [0, n) for requested coordinate ``g`` under the
    padding rule. ``zero`` clamps like ``edge``; the caller zeroes the
    out-of-range rows and columns afterwards."""
    if padding == "reflect":
        return torch.clamp(reflect_index(g, n), 0, n - 1)
    if padding in ("edge", "zero"):
        return torch.clamp(g, 0, n - 1)
    raise ValueError(f"unknown padding {padding!r}; expected one of {PAD_MODES}")


def valid_mask(k: int, j: int, h: int, w: int, block_h: int, block_w: int,
               device=None) -> torch.Tensor:
    """(block_h, block_w) bool mask of output pixels of tile (k, j) inside the
    image — False only in the ragged overhang of the last row/column tiles."""
    rv = (k * block_h + torch.arange(block_h, device=device)) < h
    cv = (j * block_w + torch.arange(block_w, device=device)) < w
    return rv[:, None] & cv[None, :]


def luma(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB -> (...) f32 grayscale as ``(0.299 R + 0.587 G) + 0.114 B``.

    Each product is a separate f32 multiply and each sum a separate add, so
    no step is contracted into an FMA.
    """
    x = rgb.to(torch.float32)
    return (
        x[..., 0] * LUMA_WEIGHTS[0] + x[..., 1] * LUMA_WEIGHTS[1]
    ) + x[..., 2] * LUMA_WEIGHTS[2]


# ---------------------------------------------------------------------------
# Cost model (the tuner's sweep rows)
# ---------------------------------------------------------------------------

def halo_amplification(block_h: int, block_w: int, r: int) -> float:
    """Fraction of extra input reads against a halo-free ideal (unclamped
    window)."""
    halo = 2 * r
    return (1.0 + halo / block_h) * (1.0 + halo / block_w) - 1.0


def window_amplification(h: int, w: int, block_h: int, block_w: int, r: int, *,
                         align: Tuple[int, int] = ALIGN_INTERPRET) -> float:
    """Like :func:`halo_amplification`, for the clamped window an ``h x w``
    image gives."""
    th, tw = window_shape(h, w, block_h, block_w, r, align=align)
    return (th * tw) / float(min(block_h, h) * min(block_w, w)) - 1.0
