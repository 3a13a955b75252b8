"""Exact integer-accumulation budgets for the integer lane.

A u8 frame correlated with *integer* taps never needs floating point in the
gradient ladder: every intermediate the variant ladder materializes is an
exact integer bounded by ``input_max * sum(|taps|)``, so the ladder can run
in i16/i32 and convert to f32 only at the magnitude/NMS boundary, and the
result is bit-identical to the f32 lane (f32 holds every integer up to
2^24 exactly).

A stencil plan chains the bound through its pre-stages first
(:func:`plan_input_bound`) and then applies the operator proof to its
gradient stage with the chained bound (:func:`plan_int_eligible`,
:func:`plan_accum_dtype`).

This module is the single source of those budgets for the port: the
dispatcher (``kernels.dispatch.resolve_precision``) gates
``EdgeConfig.precision`` on them, and the kernels and the plain ladder pick
their accumulation dtype from :func:`accum_dtype`. The reason strings are
``repro.core.ladder``'s, word for word.

Bound derivation: per direction the response is ``sum_t taps[t] * x[t]``
with ``0 <= x <= input_max``, so ``|response| <= input_max * sum|taps|``.
Partial sums and the separable row/column passes obey the same triangle
inequality. The v1/v2 transform forms ``gd_plus = gd + gdt`` and
``gd_minus = gd - gdt`` (Eq. 10-11), so for 4-direction banks the binding
bound is the pairwise one, the two largest per-direction bounds added. The
halving of ``gd_plus +- gd_minus`` is exact in integers because the sum is
even by construction; the kernels spell it as an arithmetic right shift.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "F32_EXACT_INT",
    "tap_accumulation_bounds",
    "accum_dtype",
    "int_lane_eligible",
    "plan_input_bound",
    "plan_int_eligible",
    "plan_accum_dtype",
]

# Exact-representation ceilings for the dtype ladder.
F32_EXACT_INT = 2**24
_I16_MAX = 2**15 - 1
_I32_MAX = 2**31 - 1


def _dtype_name(dtype) -> str:
    """numpy's name for a numpy or torch dtype (``torch.uint8`` -> ``uint8``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return np.dtype(dtype).name


def tap_accumulation_bounds(spec, *, input_max: int = 255) -> Dict[str, object]:
    """Worst-case accumulation magnitude of ``input_max``-bounded input
    against the spec's dense filter bank.

    Per direction the bound is ``input_max * sum(|taps|)``; for 4-direction
    operators the pairwise bound (the two largest per-direction sums added)
    covers every intermediate the v1/v2 transform materializes. Gradients
    only: the magnitude and NMS stay f32.
    """
    bank = spec.bank(max(spec.directions))
    integer = bool(np.all(bank == np.round(bank)))
    per_dir = [float(input_max * np.abs(k).sum()) for k in bank]
    worst = max(per_dir)
    if len(per_dir) >= 4:
        worst = sum(sorted(per_dir)[-2:])
    return {
        "integer_taps": integer,
        "per_direction": per_dir,
        "worst": worst,
        "fits_i16": worst <= _I16_MAX,
        "fits_i32": worst <= _I32_MAX,
        "f32_exact": worst <= F32_EXACT_INT,
    }


def accum_dtype(spec, *, input_max: int = 255) -> Optional[str]:
    """Narrowest exact integer accumulation dtype for the spec, or None.

    ``"int16"``/``"int32"`` when the integer lane is provably bit-exact
    against the f32 lane for ``input_max``-bounded (u8) input: integer
    taps, a bound that fits the dtype, and a bound within f32's exact
    integer range (else the f32 lane itself rounds).
    """
    b = tap_accumulation_bounds(spec, input_max=input_max)
    if not b["integer_taps"] or not b["f32_exact"]:
        return None
    if b["fits_i16"]:
        return "int16"
    if b["fits_i32"]:
        return "int32"
    return None


def int_lane_eligible(
    spec, *, rgb: bool, input_dtype=None, input_max: int = 255
) -> Tuple[bool, str]:
    """(eligible, reason) for running the exact integer lane.

    ``reason`` names the first failing gate (used verbatim in the
    ``precision="int"`` error). RGB input is ineligible by design: the
    BT.601 luma weights are fractional and no fixed-point luma reproduces
    the f32 roundings bit for bit. ``input_dtype`` may be a numpy or a
    torch dtype.
    """
    ok, reason = _lane_input_gates(rgb, input_dtype)
    if not ok:
        return ok, reason
    b = tap_accumulation_bounds(spec, input_max=input_max)
    if not b["integer_taps"]:
        return False, f"operator {spec.name!r} has fractional taps"
    if not b["f32_exact"]:
        return False, (
            f"accumulation bound {b['worst']:.0f} exceeds f32's exact "
            "integer range (2^24); the f32 lane itself rounds"
        )
    if not b["fits_i32"]:
        return False, (
            f"accumulation bound {b['worst']:.0f} exceeds i32"
        )
    return True, ""


def _lane_input_gates(rgb: bool, input_dtype) -> Tuple[bool, str]:
    """The RGB and dtype gates of the integer lane, in the reference's words."""
    if rgb:
        return False, (
            "RGB input needs the fractional BT.601 luma, whose fenced f32 "
            "rounding has no bit-exact fixed-point equivalent"
        )
    if input_dtype is not None and _dtype_name(input_dtype) != "uint8":
        return False, (
            f"input dtype {_dtype_name(input_dtype)} is not uint8 — the "
            "integer bound only covers [0, 255] integer frames"
        )
    return True, ""


def plan_input_bound(plan, *, input_max: int = 255):
    """(bound, reason): the gradient stage's input magnitude bound after the
    plan's pre-stages, or (None, reason) when a pre-stage leaves the
    integer lane; ``reason`` names the failing gate.

    Window max/min selects an input value (bound kept); an integer-tap
    linear stage multiplies the bound by ``sum|taps|``; a fractional-tap
    stage (the normalized Gaussians) has no exact integer form; a pointwise
    fn carries its own registered bound transform (``abs`` keeps it,
    ``square`` squares it).
    """
    from repro_torch.core import filters as F

    m = float(input_max)
    for stage in plan.pre_stages:
        if stage.kind == "window_reduce":
            continue
        if stage.kind == "linear":
            bank = stage.operator.bank(1)
            if not np.all(bank == np.round(bank)):
                return None, (
                    f"plan gate 'integer-taps': stage {stage.name!r} has "
                    "fractional taps (no exact integer form)"
                )
            m = m * float(np.abs(bank[0]).sum())
        elif stage.kind == "pointwise":
            _fn, bound = F.get_pointwise(stage.op)
            if bound is None:
                return None, (
                    f"plan gate 'integer-taps': pointwise stage "
                    f"{stage.name!r} has no integer bound transform"
                )
            m = float(bound(m))
        if m > F32_EXACT_INT:
            return None, (
                f"plan gate 'integer-taps': bound {m:.0f} after stage "
                f"{stage.name!r} exceeds f32's exact integer range (2^24)"
            )
    return m, ""


def plan_int_eligible(
    plan, *, rgb: bool, input_dtype=None, input_max: int = 255
) -> Tuple[bool, str]:
    """Plan-level (eligible, reason) for the exact integer lane; a plan of
    one gradient stage reduces to :func:`int_lane_eligible`."""
    spec = plan.gradient
    if spec is None:
        return False, (
            f"plan {plan.name!r} has no gradient stage; the integer lane "
            "covers gradient plans only"
        )
    if not plan.pre_stages:
        return int_lane_eligible(spec, rgb=rgb, input_dtype=input_dtype, input_max=input_max)
    ok, reason = _lane_input_gates(rgb, input_dtype)
    if not ok:
        return ok, reason
    m, reason = plan_input_bound(plan, input_max=input_max)
    if m is None:
        return False, reason
    b = tap_accumulation_bounds(spec, input_max=m)
    if not b["integer_taps"]:
        return False, f"operator {spec.name!r} has fractional taps"
    if not b["f32_exact"]:
        return False, (
            f"accumulation bound {b['worst']:.0f} exceeds f32's exact "
            "integer range (2^24); the f32 lane itself rounds"
        )
    if not b["fits_i32"]:
        return False, f"accumulation bound {b['worst']:.0f} exceeds i32"
    return True, ""


def plan_accum_dtype(plan, *, input_max: int = 255) -> Optional[str]:
    """Narrowest exact integer accumulation dtype for the whole plan."""
    spec = plan.gradient
    if spec is None:
        return None
    if not plan.pre_stages:
        return accum_dtype(spec, input_max=input_max)
    m, _reason = plan_input_bound(plan, input_max=input_max)
    if m is None:
        return None
    b = tap_accumulation_bounds(spec, input_max=m)
    if not b["integer_taps"] or not b["f32_exact"]:
        return None
    if b["fits_i16"]:
        return "int16"
    if b["fits_i32"]:
        return "int32"
    return None
