"""Deterministic synthetic image batches, a pure function of ``(seed, step)``.

A copy of ``repro.data.synthetic.image_batch``, so both packages serve the
same frames from the same seed.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig

__all__ = ["image_batch"]


def image_batch(
    cfg: ModelConfig, batch: int, *, seed: int = 0, step: int = 0
) -> Dict[str, np.ndarray]:
    """Batch of synthetic images (blocks + gradients => real edges)."""
    rng = np.random.default_rng((seed * 1_000_003 + step) & 0x7FFFFFFF)
    h, w = cfg.image_h, cfg.image_w
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs = np.empty((batch, h, w), np.float32)
    for i in range(batch):
        base = 40.0 + 50.0 * np.sin(xx / rng.uniform(8, 64)) * np.cos(yy / rng.uniform(8, 64))
        cx, cy, r = rng.uniform(0, w), rng.uniform(0, h), rng.uniform(min(h, w) / 8, min(h, w) / 3)
        disk = ((xx - cx) ** 2 + (yy - cy) ** 2) < r * r
        imgs[i] = np.clip(base + 120.0 * disk + rng.normal(0, 2, (h, w)), 0, 255)
    return {"images": imgs}
