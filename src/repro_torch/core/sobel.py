"""Multi-directional Sobel operator — the paper's variant ladder in plain PyTorch.

Variants (paper Table 1):
  * ``direct``    — dense 2-D correlation per direction.
  * ``separable`` — "RG": K_x / K_y through their separable factors
                    (Eq. 5-7); K_d / K_dt still dense.
  * ``v1``        — "RG-v1": the diagonal transform K_d± = K_d ± K_dt
                    (Eq. 10-17), one horizontal pass per distinct row.
  * ``v2``        — "RG-v2": K_d- split into two separable products
                    (Eq. 18-19), the first reusing K_x's horizontal pass F.

The operation order is part of the result. Every function here does, tap
for tap, the f32 operations ``repro.core.sobel`` does — zero taps skipped,
±1 taps without a multiply, left-to-right accumulation — and each
elementwise step is its own PyTorch op, so nothing is contracted into an
FMA. This is the plain version the CUDA kernel (``kernels/csrc/edge.cu``)
is held against. Inputs may carry leading batch dims: ``(..., H, W)``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import filters as F
from repro_torch.core.filters import SobelParams
from repro_torch.kernels.tiling import boundary_index

__all__ = [
    "sobel",
    "sobel_components",
    "spec_components",
    "plan_components",
    "magnitude",
    "VARIANTS",
]

VARIANTS = F.LADDER


def _tap(term: torch.Tensor, w: float) -> torch.Tensor:
    """``w * term``; ±1 taps skip the multiply.

    An integer tensor (the exact integer lane, ``core/ladder.py``) multiplies
    by ``int(w)`` in its own dtype; a fractional tap cannot reach it.
    """
    if w == 1.0:
        return term
    if w == -1.0:
        return -term
    if not term.is_floating_point():
        if w != int(w):
            raise ValueError(
                f"fractional tap {w!r} reached the integer lane; "
                "repro_torch.core.ladder.int_lane_eligible should have gated this"
            )
        return term * int(w)
    return term * w


def _halve(x: torch.Tensor) -> torch.Tensor:
    """Exact ``x / 2`` of the operator transform's sums, which are even by
    construction: an arithmetic ``>> 1`` on the integer lane, ``* 0.5`` in
    f32 (scaling by 2^-1)."""
    if not x.is_floating_point():
        return x >> 1
    return x * 0.5


def _hpass(x: torch.Tensor, taps: np.ndarray, out_w: int) -> torch.Tensor:
    """Horizontal correlation: out[..., y, j] = sum_t taps[t] * x[..., y, j+t].
    Zero taps are skipped (the paper's F pass is 4 MACs, D is 2)."""
    acc = None
    for t, w in enumerate(np.asarray(taps).tolist()):
        if w == 0.0:
            continue
        term = _tap(x[..., t:t + out_w], w)
        acc = term if acc is None else acc + term
    if acc is None:
        return x.new_zeros(x.shape[:-1] + (out_w,))
    return acc


def _vpass(x: torch.Tensor, taps: np.ndarray, out_h: int) -> torch.Tensor:
    """Vertical correlation: out[..., i, x] = sum_t taps[t] * x[..., i+t, x]."""
    acc = None
    for t, w in enumerate(np.asarray(taps).tolist()):
        if w == 0.0:
            continue
        term = _tap(x[..., t:t + out_h, :], w)
        acc = term if acc is None else acc + term
    if acc is None:
        return x.new_zeros(x.shape[:-2] + (out_h,) + x.shape[-1:])
    return acc


def _correlate2d(x: torch.Tensor, kernel: np.ndarray, out_h: int, out_w: int) -> torch.Tensor:
    """Dense 2-D correlation via shifted slices (valid region), row-major taps."""
    kh, kw = kernel.shape
    acc = None
    for i in range(kh):
        for j in range(kw):
            w = float(kernel[i, j])
            if w == 0.0:
                continue
            term = _tap(x[..., i:i + out_h, j:j + out_w], w)
            acc = term if acc is None else acc + term
    if acc is None:
        raise ValueError("all-zero correlation kernel")
    return acc


def _sym_rowpass(xp: torch.Tensor, dense: np.ndarray, h: int, w: int) -> torch.Tensor:
    """Dense correlation with one horizontal pass per *distinct* row (Eqs. 13-17).

    Rows equal to an earlier row reuse its pass; rows equal to its negation
    reuse it with a subtract; all-zero rows are skipped.
    """
    dense = np.asarray(dense, np.float32)
    passes = {}
    acc = None
    for i, r_ in enumerate(dense):
        if not np.any(r_):
            continue
        key, nkey = tuple(r_.tolist()), tuple((-r_).tolist())
        if key in passes:
            f, sign = passes[key], 1.0
        elif nkey in passes:
            f, sign = passes[nkey], -1.0
        else:
            f, sign = passes.setdefault(key, _hpass(xp, r_, w)), 1.0
        term = f[..., i:i + h, :]
        if acc is None:
            acc = term if sign > 0 else -term
        else:
            acc = acc + term if sign > 0 else acc - term
    if acc is None:
        raise ValueError("all-zero correlation kernel")
    return acc


def spec_components(
    xp: torch.Tensor, spec: F.OperatorSpec, h: int, w: int, variant: str, directions: int
) -> Tuple[torch.Tensor, ...]:
    """Direction components of ``spec`` on the pre-padded image ``xp``.

    ``variant``/``directions`` must already be resolved against the spec.
    The arithmetic runs in ``xp.dtype``: f32, or the integer lane's i16/i32.
    """
    if variant == "direct":
        return tuple(_correlate2d(xp, k, h, w) for k in spec.bank(directions))

    col_x, row_x = spec.sep_factors(0)
    col_y, row_y = spec.sep_factors(1)
    f = _hpass(xp, row_x, w)  # the reused F pass
    s = _hpass(xp, row_y, w)
    gx = _vpass(f, col_x, h)
    gy = _vpass(s, col_y, h)
    if directions == 2:
        return (gx, gy)

    if variant == "separable":
        bank = spec.bank(4)
        return (gx, gy, _correlate2d(xp, bank[2], h, w), _correlate2d(xp, bank[3], h, w))

    gd_plus = _sym_rowpass(xp, spec.kd_plus_dense(), h, w)
    if variant == "v1":
        gd_minus = _sym_rowpass(xp, spec.kd_minus_dense(), h, w)
    elif variant == "v2":
        col_f, col_d, row_d = spec.v2_arrays()
        d = _hpass(xp, row_d, w)  # 2-tap difference D = p3 - p1
        gd_minus = _vpass(f, col_f, h) - _vpass(d, col_d, h)
    else:
        raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    gd = _halve(gd_plus + gd_minus)   # Eq. 11
    gdt = _halve(gd_plus - gd_minus)
    return (gx, gy, gd, gdt)


# ---------------------------------------------------------------------------
# StencilPlan chaining: single-plane pre-stages on shrinking extents, then the
# gradient stage through the ladder above (repro.core.sobel.plan_components).
# ---------------------------------------------------------------------------

def _window_reduce(x: torch.Tensor, r: int, mode: str, out_h: int, out_w: int) -> torch.Tensor:
    """Separable ``(2r+1)``-square max/min (dilate/erode): a horizontal then
    a vertical pass, each folding its slices left to right with the
    NaN-propagating ``torch.maximum``/``torch.minimum``."""
    op = torch.maximum if mode == "max" else torch.minimum
    acc = None
    for t in range(2 * r + 1):
        s = x[..., t:t + out_w]
        acc = s if acc is None else op(acc, s)
    x = acc
    acc = None
    for t in range(2 * r + 1):
        s = x[..., t:t + out_h, :]
        acc = s if acc is None else op(acc, s)
    return acc


def _stage_apply(x: torch.Tensor, stage, out_h: int, out_w: int) -> torch.Tensor:
    """Apply one single-plane stage to ``x`` (extent ``out + 2 * radius``)."""
    if stage.kind == "linear":
        spec = stage.operator
        fac = spec.sep_factors(0)
        if fac is not None:
            col, row = fac
            return _vpass(_hpass(x, row, out_w), col, out_h)
        return _correlate2d(x, spec.bank(1)[0], out_h, out_w)
    if stage.kind == "window_reduce":
        return _window_reduce(x, stage.radius, stage.op, out_h, out_w)
    if stage.kind == "pointwise":
        fn, _bound = F.get_pointwise(stage.op)
        return fn(x)
    raise ValueError(f"stage {stage.name!r} (kind {stage.kind!r}) is not a "
                     "single-plane stage")


def plan_components(ext: torch.Tensor, plan, h: int, w: int, variant: str,
                    directions: int) -> Tuple[torch.Tensor, ...]:
    """Direction components of ``plan`` on ``ext``, the input extended by
    ``plan.linear_reach`` on each side (``(h + 2R, w + 2R)``).

    The input is extended once, by the composed reach, and each pre-stage
    consumes its own radius off that margin: stage ``k``'s output extent
    is ``h + 2 * (the radii still to come)``, so near the border a blurred
    value is the blur of the extended input, never an extension of the
    blurred plane. After the last pre-stage the plane is extended by the
    gradient's radius and :func:`spec_components` finishes the chain. A
    plan without a gradient returns its last plane as a 1-tuple.
    """
    cur = ext
    remaining = plan.linear_reach
    for stage in plan.pre_stages:
        remaining -= stage.radius
        cur = _stage_apply(cur, stage, h + 2 * remaining, w + 2 * remaining)
    spec = plan.gradient
    if spec is None:
        return (cur,)
    return spec_components(cur, spec, h, w, variant, directions)


def _pad(image: torch.Tensor, r: int, padding: str) -> Tuple[torch.Tensor, int, int]:
    """Boundary-extend the last two dims by ``r`` under ``padding``.

    Index maps, not ``F.pad``: ``reflect`` must work when ``r`` is at least
    the axis length (mirror-periodic, numpy semantics). Keeps the dtype.
    """
    h, w = image.shape[-2], image.shape[-1]
    if padding == "valid":
        return image, h - 2 * r, w - 2 * r
    gr = torch.arange(-r, h + r, device=image.device)
    gc = torch.arange(-r, w + r, device=image.device)
    xp = image.index_select(-2, boundary_index(gr, h, padding))
    xp = xp.index_select(-1, boundary_index(gc, w, padding))
    if padding == "zero":
        inside = ((gr >= 0) & (gr < h))[:, None] & ((gc >= 0) & (gc < w))[None, :]
        xp = torch.where(inside, xp, xp.new_zeros(()))
    return xp, h, w


def sobel_components(
    image: torch.Tensor,
    *,
    size: int = 5,
    directions: int = 0,
    variant: str = "v2",
    params: SobelParams = SobelParams(),
    padding: str = "reflect",
    operator: "str | None" = None,
    precision: str = "f32",
    plan=None,
) -> Tuple[torch.Tensor, ...]:
    """Per-direction gradient images ``(G_x, G_y[, G_d, G_dt])`` in f32.

    ``operator`` names any registered operator; when omitted, ``size``
    picks the Sobel operator of that size. ``directions`` of 0 means the
    operator's maximum.

    ``plan`` (a :class:`~repro_torch.core.filters.StencilPlan` or a
    registered plan name) chains the plan's pre-stages ahead of its
    gradient stage with one pad of ``plan.linear_reach``
    (:func:`plan_components`). It overrides ``operator``/``size`` and must
    carry a gradient stage.

    ``precision="int"`` runs the exact integer lane: the uint8 image is cast
    to the i16/i32 dtype ``core.ladder.accum_dtype`` proves, the ladder
    accumulates in integers, and the components are cast to f32 on return,
    bit-identical to the f32 lane. Raises ``ValueError`` naming the first
    failing gate for inputs or operators the budget does not cover.
    """
    if variant not in VARIANTS and variant != "auto":
        raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    if precision not in ("f32", "int"):
        raise ValueError(f"unknown precision {precision!r}; expected 'f32' or 'int'")
    if plan is not None:
        plan = F.resolve_plan(plan)
        spec = plan.gradient
        if spec is None:
            raise ValueError(
                f"plan {plan.name!r} has no gradient stage; "
                "sobel_components returns direction components"
            )
        reach = plan.linear_reach
    else:
        spec = F.get_operator(operator or F.operator_for_size(size), params)
        reach = spec.radius
    directions = spec.resolve_directions(directions)
    variant = spec.resolve_variant(variant)
    image = torch.as_tensor(image)
    x = to_lane(image, spec, precision, plan=plan)
    xp, h, w = _pad(x, reach, padding)
    if plan is not None:
        comps = plan_components(xp, plan, h, w, variant, directions)
    else:
        comps = spec_components(xp, spec, h, w, variant, directions)
    if precision == "int":
        comps = tuple(c.to(torch.float32) for c in comps)
    return comps


def to_lane(gray: torch.Tensor, spec: F.OperatorSpec, precision: str,
            plan=None) -> torch.Tensor:
    """``gray`` in the lane's ladder dtype: f32, or for ``precision="int"``
    the integer dtype ``core.ladder.accum_dtype`` (``plan_accum_dtype``
    with a plan) licenses, after checking that the lane covers this input,
    operator and plan."""
    if precision != "int":
        return gray.to(torch.float32)
    from repro_torch.core import ladder

    if plan is not None:
        ok, reason = ladder.plan_int_eligible(plan, rgb=False, input_dtype=gray.dtype)
    else:
        ok, reason = ladder.int_lane_eligible(spec, rgb=False, input_dtype=gray.dtype)
    if not ok:
        raise ValueError(f"precision='int' unavailable: {reason}")
    acc = ladder.plan_accum_dtype(plan) if plan is not None else ladder.accum_dtype(spec)
    return gray.to(getattr(torch, acc))


def magnitude(components: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """Root-sum-of-squares aggregation (Eq. 2 / Eq. 4): ``((g0² + g1²) + g2²) + g3²``.

    The square root is taken in f64 and rounded once to f32, which is the
    correctly rounded f32 square root (IEEE ``sqrtf``); PyTorch's vectorized
    f32 ``sqrt`` on the CPU is not.
    """
    acc = None
    for g in components:
        g2 = g * g
        acc = g2 if acc is None else acc + g2
    return torch.sqrt(acc.to(torch.float64)).to(torch.float32)


def sobel(
    image: torch.Tensor,
    *,
    size: int = 5,
    directions: int = 0,
    variant: str = "v2",
    params: SobelParams = SobelParams(),
    padding: str = "reflect",
    return_components: bool = False,
    operator: "str | None" = None,
    precision: str = "f32",
    plan=None,
):
    """Multi-directional edge magnitude ``G`` (paper Eq. 4).

    Args:
      image: ``(..., H, W)`` grayscale image(s); any real dtype.
      size: 3, 5 or 7 (operator selector; ignored when ``operator`` is set).
      directions: 2 or 4; 0 (default) = the operator's maximum.
      variant: ``direct | separable | v1 | v2`` (coerced to the operator's
        best supported variant; identical results).
      params: generalized weights (Sobel-5x5 family only).
      padding: ``reflect | edge | zero`` (same-size output) or ``valid``.
      return_components: also return the per-direction gradients.
      operator: registered operator name (overrides ``size``).
      precision: ``f32``, or ``int`` for the exact integer lane (u8 input,
        integer taps; bit-identical to ``f32``).
      plan: a stencil plan (or its registered name) whose pre-stages run
        ahead of its gradient stage (see :func:`sobel_components`).
    """
    comps = sobel_components(
        image,
        size=size,
        directions=directions,
        variant=variant,
        params=params,
        padding=padding,
        operator=operator,
        precision=precision,
        plan=plan,
    )
    g = magnitude(comps)
    if return_components:
        return g, comps
    return g
