"""Gradient post-processing: non-maximum suppression and hysteresis linking.

The plain PyTorch counterpart of ``repro.core.nms``, and the plain version
the CUDA kernel's NMS outputs (``kernels/csrc/edge.cu`` with ``out_nms``)
are held against:

  * **Direction-aware NMS.** A pixel survives only if its magnitude is a
    local maximum along the gradient direction. With four directions the
    sector is the exact argmax of ``(|G_x|, |G_y|, |G_d|, |G_dt|)`` (first
    index wins ties); with two it is the quantized-orientation rule,
    written as comparisons against the f32 rounding of ``tan(pi/8)``.
    Comparisons, selections and slices only, so the thin map is bit for
    bit the same on every device.
  * **Double threshold and hysteresis.** ``thin > high`` seeds strong
    edges; they grow through their 8-neighbourhood into the ``thin > low``
    weak set until nothing changes. Thresholds are fractions of the
    per-image magnitude peak; strict ``>`` keeps blank frames edge-free.

The magnitude neighbourhood needs one extra ring: :func:`thin_map` pads the
image by ``radius + 1`` and evaluates the ladder on the ``(H+2, W+2)``
extended output, so NMS at the border compares against the magnitude of
the boundary-extended image, which is what the kernel's ``radius + 1`` halo
window computes per tile.

Hysteresis is a global fixpoint (an edge chain may cross every tile), so it
runs on the assembled thin map. The reference runs it as an XLA
``while_loop`` that tests for the fixpoint after every step; here it is a
loop of PyTorch ops that tests after bursts of steps: a step past the
fixpoint changes nothing, so the answer is the same.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.sobel import _pad, magnitude, plan_components, spec_components, to_lane

__all__ = [
    "DEFAULT_LOW",
    "DEFAULT_HIGH",
    "TEMPORAL_FLOOR",
    "TAN_PI8_F32",
    "nms_sector",
    "nms_thin",
    "thin_map",
    "resolve_thresholds",
    "hysteresis",
    "temporal_seeds",
    "update_seed_strength",
]

# Auto double-threshold defaults: fractions of the per-image magnitude peak.
DEFAULT_LOW = 0.10
DEFAULT_HIGH = 0.20

# Temporal hysteresis: a past edge keeps seeding while its decayed strength
# stays strictly above this floor.
TEMPORAL_FLOOR = 0.5

# Longest run of hysteresis dilation steps between two fixpoint tests.
MAX_BURST = 64

# tan(pi/8) rounded to f32: the sector boundary of the 2-direction rule. The
# CUDA kernel receives this very value from Python.
TAN_PI8_F32 = np.float32(math.tan(math.pi / 8.0))


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    """A 0-d f32 tensor of ``v`` on ``like``'s device (a fill, not a copy)."""
    return torch.full((), float(np.float32(v)), dtype=torch.float32, device=like.device)


def nms_sector(comps: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """int32 gradient-sector map from the direction components.

    0 compares west/east ``(y, x -+ 1)``, 1 north/south ``(y -+ 1, x)``,
    2 the main diagonal ``(y -+ 1, x -+ 1)``, 3 the anti-diagonal
    ``(y -+ 1, x +- 1)``. Four components: argmax of the absolute responses,
    first index winning ties. Two: ``|G_y| <= t |G_x|`` is horizontal,
    ``|G_x| <= t |G_y|`` vertical, else the diagonal whose sign the two
    components agree on.
    """
    def const(v, like):
        return torch.full_like(like, v, dtype=torch.int32)

    if len(comps) == 4:
        a0, a1, a2, a3 = (g.abs() for g in comps)
        s23 = torch.where(a2 >= a3, const(2, a0), const(3, a0))
        s123 = torch.where((a1 >= a2) & (a1 >= a3), const(1, a0), s23)
        return torch.where((a0 >= a1) & (a0 >= a2) & (a0 >= a3), const(0, a0), s123)
    if len(comps) != 2:
        raise ValueError(f"nms_sector needs 2 or 4 components, got {len(comps)}")
    gx, gy = comps
    ax, ay = gx.abs(), gy.abs()
    t = _f32(TAN_PI8_F32, gx)
    diag = torch.where((gx >= 0) == (gy >= 0), const(2, ax), const(3, ax))
    return torch.where(ay <= t * ax, const(0, ax),
                       torch.where(ax <= t * ay, const(1, ax), diag))


def nms_thin(mag_ext: torch.Tensor, sector: torch.Tensor) -> torch.Tensor:
    """``(..., H+2, W+2)`` magnitude and ``(..., H, W)`` sectors ->
    ``(..., H, W)`` thin magnitude: a pixel is kept when it is ``>=`` both
    neighbours along its sector; the others become exactly 0."""
    h, w = sector.shape[-2], sector.shape[-1]

    def sl(dr: int, dc: int) -> torch.Tensor:
        return mag_ext[..., 1 + dr:1 + dr + h, 1 + dc:1 + dc + w]

    c = sl(0, 0)
    n1 = torch.where(sector == 0, sl(0, -1),
         torch.where(sector == 1, sl(-1, 0),
         torch.where(sector == 2, sl(-1, -1), sl(-1, 1))))
    n2 = torch.where(sector == 0, sl(0, 1),
         torch.where(sector == 1, sl(1, 0),
         torch.where(sector == 2, sl(1, 1), sl(1, -1))))
    keep = (c >= n1) & (c >= n2)
    return torch.where(keep, c, torch.zeros_like(c))


def thin_map(
    gray: torch.Tensor,
    spec,
    *,
    variant: str,
    directions: int,
    padding: str = "reflect",
    precision: str = "f32",
    plan=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...], torch.Tensor]:
    """Gray ``(..., H, W)`` -> ``(thin, center components, center
    magnitude)``; the magnitude is the un-thinned one, the peak's source.

    The image is padded by the linear reach + 1 (``spec.radius + 1``, or
    ``plan.linear_reach + 1`` when ``plan`` chains pre-stages) and the
    ladder (``plan_components`` with a plan) runs on the ``(H+2, W+2)``
    extended output, so the NMS neighbourhood exists at the border.
    ``precision="int"`` runs the ladder in the integer dtype
    ``core.ladder`` proves for u8 ``gray`` and casts the components to f32
    before the magnitude and the sector, which stay f32: bit-identical to
    the f32 lane.
    """
    h, w = gray.shape[-2], gray.shape[-1]
    reach = plan.linear_reach if plan is not None else spec.radius
    xp, _, _ = _pad(to_lane(gray, spec, precision, plan=plan), reach + 1, padding)
    if plan is not None:
        comps_ext = plan_components(xp, plan, h + 2, w + 2, variant, directions)
    else:
        comps_ext = spec_components(xp, spec, h + 2, w + 2, variant, directions)
    if precision == "int":
        comps_ext = tuple(c.to(torch.float32) for c in comps_ext)
    mag_ext = magnitude(comps_ext)

    def center(a: torch.Tensor) -> torch.Tensor:
        return a[..., 1:1 + h, 1:1 + w]

    comps = tuple(center(g) for g in comps_ext)
    thin = nms_thin(mag_ext, nms_sector(comps))
    return thin, comps, center(mag_ext)


def resolve_thresholds(
    peak: torch.Tensor,
    low: Optional[float] = None,
    high: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absolute ``(low, high)`` thresholds: the f32 peak times the f32
    fractions (default :data:`DEFAULT_LOW` / :data:`DEFAULT_HIGH`)."""
    lo = DEFAULT_LOW if low is None else low
    hi = DEFAULT_HIGH if high is None else high
    peak = peak.to(torch.float32)
    return peak * _f32(lo, peak), peak * _f32(hi, peak)


def _dilate8(m: torch.Tensor) -> torch.Tensor:
    """8-neighbourhood boolean dilation (centre included, zero ring), as a
    row pass then a column pass: OR is associative, so it equals the
    nine-way OR."""
    h, w = m.shape[-2], m.shape[-1]
    p = m.new_zeros(m.shape[:-2] + (h + 2, w + 2))
    p[..., 1:h + 1, 1:w + 1] = m
    rows = p[..., :, 0:w] | p[..., :, 1:w + 1] | p[..., :, 2:w + 2]
    return rows[..., 0:h, :] | rows[..., 1:h + 1, :] | rows[..., 2:h + 2, :]


def hysteresis(
    thin: torch.Tensor,
    low: torch.Tensor,
    high: torch.Tensor,
    seed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Double threshold and linking to the fixpoint; returns a bool map.

    Strong pixels (``thin > high``, and weak) are edges; weak pixels
    (``thin > low``) become edges when 8-connected to an edge, transitively.
    ``seed`` adds strong seeds where the frame is at least weak (temporal
    hysteresis); an all-False seed gives the same answer as none.

    The dilation steps run in bursts of 1, 2, 4, ... up to
    :data:`MAX_BURST` between fixpoint tests (a test reads one flag back
    from the device): a map at its fixpoint costs one step and one test, a
    long chain O(log) tests. ``hysteresis.iterations`` holds the dilation
    steps the last call ran.
    """
    weak = thin > low
    strong = (thin > high) & weak
    if seed is not None:
        strong = strong | (seed & weak)
    cur = strong
    steps, burst = 0, 1
    while True:
        before = cur
        for _ in range(burst):
            cur = _dilate8(cur) & weak
        steps += burst
        # The steps only grow the map, so equal ends of a burst mean every
        # step in it changed nothing: the fixpoint.
        if torch.equal(cur, before):
            break
        burst = min(2 * burst, MAX_BURST)
    hysteresis.iterations = steps
    return cur


hysteresis.iterations = 0


def temporal_seeds(
    strength: torch.Tensor, decay: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decay the per-pixel seed strength by one frame: returns ``(seed,
    decayed)`` with ``decayed = strength * decay`` and ``seed = decayed >
    TEMPORAL_FLOOR``."""
    decayed = strength * _f32(decay, strength)
    return decayed > _f32(TEMPORAL_FLOOR, strength), decayed


def update_seed_strength(
    decayed: torch.Tensor, edges: torch.Tensor
) -> torch.Tensor:
    """This frame's edges snap back to strength 1.0; the rest keep their
    decayed strength."""
    return torch.maximum(edges.to(torch.float32), decayed)
