"""Exact integer-accumulation budgets for the integer lane.

A u8 frame correlated with *integer* taps never needs floating point in the
gradient ladder: every intermediate the variant ladder materializes is an
exact integer bounded by ``input_max * sum(|taps|)``, so the ladder can run
in i16/i32 and convert to f32 only at the magnitude/NMS boundary, and the
result is bit-identical to the f32 lane (f32 holds every integer up to
2^24 exactly).

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
