"""Deterministic synthetic data, a pure function of ``(seed, step)``: token
batches (with the stub frontends' inputs) and image frames.

Copies of ``repro.data.synthetic.lm_batch``, ``image_batch`` and
``video_frame``, so both packages make the same numpy arrays from the same
seed.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig

__all__ = ["lm_batch", "image_batch", "video_frame"]


def _perm(vocab: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed ^ 0x5EED).permutation(vocab)


def lm_batch(
    cfg: ModelConfig,
    batch: int,
    seq_len: int,
    *,
    seed: int = 0,
    step: int = 0,
    noise: float = 0.25,
) -> Dict[str, np.ndarray]:
    """A batch for any LM-family arch: a bigram token stream (each token's
    successor is ``perm[token]`` with probability ``1 - noise``) and its
    labels, plus the stub frontends' inputs: a VLM's ``patch_embeds``
    (``num_patches`` of its ``seq_len`` positions, the text the rest) and
    an encoder-decoder's ``enc_embeds`` (``min(encoder_len, seq_len)``
    frames), both N(0, 1) x 0.02."""
    rng = np.random.default_rng((seed * 1_000_003 + step) & 0x7FFFFFFF)
    vocab = max(cfg.vocab_size, 2)
    perm = _perm(vocab, seed)

    vlm = cfg.family == "vlm" and cfg.frontend == "vision_stub"
    text_len = seq_len - cfg.num_patches if vlm else seq_len
    if vlm and text_len <= 1:
        raise ValueError(f"seq_len {seq_len} leaves {text_len} text tokens after "
                         f"{cfg.num_patches} patches; need at least 2")

    toks = np.empty((batch, text_len + 1), np.int32)
    toks[:, 0] = rng.integers(0, vocab, batch)
    flip = rng.random((batch, text_len)) < noise
    rand = rng.integers(0, vocab, (batch, text_len))
    for t in range(text_len):
        nxt = perm[toks[:, t]]
        toks[:, t + 1] = np.where(flip[:, t], rand[:, t], nxt)
    tokens, labels = toks[:, :-1], toks[:, 1:]

    out: Dict[str, np.ndarray] = {"tokens": tokens, "labels": labels}
    if vlm:
        p = cfg.num_patches
        out["patch_embeds"] = rng.standard_normal((batch, p, cfg.d_model)).astype(np.float32) * 0.02
        out["labels"] = np.concatenate([np.zeros((batch, p), np.int32), labels], axis=1)
        out["loss_weights"] = np.concatenate(
            [np.zeros((batch, p), np.float32), np.ones_like(labels, np.float32)], axis=1
        ).astype(np.float32)
    elif cfg.family == "encdec":
        t_enc = min(cfg.encoder_len, seq_len)
        out["enc_embeds"] = rng.standard_normal((batch, t_enc, cfg.d_model)).astype(np.float32) * 0.02
    return out


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
