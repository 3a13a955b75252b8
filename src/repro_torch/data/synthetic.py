"""Deterministic synthetic frames, a pure function of ``(seed, step)``.

Copies of ``repro.data.synthetic.image_batch`` and ``video_frame``, so both
packages serve the same frames from the same seed.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig

__all__ = ["image_batch", "video_frame"]


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


def video_frame(
    cfg: ModelConfig,
    stream: int,
    step: int,
    *,
    seed: int = 0,
    motion: float = 2.0,
    noise: float = 0.0,
) -> np.ndarray:
    """One ``uint8 (H, W)`` frame of a synthetic camera stream.

    A per-stream static textured background (the same sinusoid family as
    :func:`image_batch`) with a bright disk translating ``motion`` pixels
    per step along a per-stream direction — the camera-on-a-pole workload
    for the streaming engine. ``motion=0, noise=0`` makes every frame of a
    stream bit-identical (the delta-skip best case); ``noise > 0`` adds
    per-step sensor noise (the worst case: every tile changes every frame).
    Pure function of ``(seed, stream, step)``.
    """
    h, w = cfg.image_h, cfg.image_w
    rng = np.random.default_rng((seed * 1_000_003 + stream) & 0x7FFFFFFF)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 40.0 + 50.0 * np.sin(xx / rng.uniform(8, 64)) * np.cos(yy / rng.uniform(8, 64))
    r = min(h, w) / 6.0
    ang = rng.uniform(0, 2 * np.pi)
    cx = (w / 2.0 + motion * step * np.cos(ang)) % w
    cy = (h / 2.0 + motion * step * np.sin(ang)) % h
    disk = ((xx - cx) ** 2 + (yy - cy) ** 2) < r * r
    frame = base + 120.0 * disk
    if noise > 0:
        step_rng = np.random.default_rng(
            (seed * 1_000_003 + stream * 8191 + step * 131) & 0x7FFFFFFF
        )
        frame = frame + step_rng.normal(0, noise, (h, w))
    return np.clip(frame, 0, 255).astype(np.uint8)
