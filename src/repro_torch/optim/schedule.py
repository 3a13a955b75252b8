"""LR schedules (pure functions of step), in f32 as the reference's."""
from __future__ import annotations

import math

import numpy as np

__all__ = ["warmup_cosine", "constant"]


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> float:
    """Linear warmup from 0 to ``peak_lr`` over ``warmup_steps``, then a
    cosine down to ``final_frac * peak_lr`` at ``total_steps``. The
    reference's arithmetic, each operation rounded to f32; returns a
    Python float (an f32 value)."""
    f = np.float32
    step = f(step)
    if step < warmup_steps:
        return float(f(peak_lr) * step / f(max(1.0, warmup_steps)))
    t = (step - f(warmup_steps)) / f(max(1.0, total_steps - warmup_steps))
    t = f(min(max(t, f(0.0)), f(1.0)))
    # Python evaluates the reference's scalar factors in double, then f32
    cos = f(final_frac * peak_lr) + f((1.0 - final_frac) * peak_lr * 0.5) * (
        f(1.0) + np.cos(f(math.pi) * t))
    return float(cos)


def constant(step, *, peak_lr: float, **_) -> float:
    return float(np.float32(peak_lr))
