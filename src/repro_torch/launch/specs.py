"""Dry-run cell definitions: (arch x shape) -> abstract inputs + logical axes.

The port of ``repro.launch.specs``. ``input_specs`` returns ``meta``
tensors, of the reference's shapes and dtypes, as stand-ins for every
model input: they allocate nothing (the reference returns
``jax.ShapeDtypeStruct``s). Shape semantics, as the reference's:

  * train_4k / prefill_32k: ``seq_len`` tokens per sequence. For whisper
    the decoder carries the seq_len and the encoder sees its fixed
    ``encoder_len`` stub frames; for pixtral the first ``num_patches``
    positions are patch embeddings and the rest text tokens (total =
    seq_len).
  * decode_*: ONE new token per sequence against a KV cache of ``seq_len``.
  * long_500k: runnable only for sub-quadratic archs (ssm/hybrid); pure
    full-attention archs are recorded as skipped.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import SHAPES, ModelConfig
from repro_torch.models import Model

__all__ = [
    "cell_plan",
    "input_specs",
    "batch_logical_axes",
    "cache_logical_axes",
    "abstract_cache",
    "SOBEL_SHAPES",
]

_I32 = torch.int32
_F32 = torch.float32
_META = torch.device("meta")

# The paper's own workload gets its own shape set (cells beyond the LM ones).
SOBEL_SHAPES = {
    "edge_2k": dict(batch=256, h=2048, w=2048),
    "edge_8k": dict(batch=32, h=8192, w=8192),
}


def cell_plan(cfg: ModelConfig) -> Dict[str, Tuple[str, Optional[str]]]:
    """shape_name -> (kind, skip_reason|None)."""
    if cfg.family == "image":
        return {name: ("image", None) for name in SOBEL_SHAPES}
    plan = {}
    for name, sh in SHAPES.items():
        skip = None
        if name == "long_500k" and not cfg.sub_quadratic:
            skip = (
                "long_500k needs sub-quadratic attention; "
                f"{cfg.name} is pure full-attention (see DESIGN.md §Arch-applicability)"
            )
        plan[name] = (sh.kind, skip)
    return plan


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype, device=_META)


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict[str, torch.Tensor]:
    """Abstract batch for train/prefill kinds (tokens/labels/frontend stubs)."""
    if cfg.family == "image":
        s = SOBEL_SHAPES[shape_name]
        return {"images": _meta((s["batch"], s["h"], s["w"]), _F32)}
    sh = SHAPES[shape_name]
    b, s = sh.global_batch, sh.seq_len
    if cfg.family == "vlm":
        text = s - cfg.num_patches
        return {
            "tokens": _meta((b, text), _I32),
            "labels": _meta((b, s), _I32),
            "loss_weights": _meta((b, s), _F32),
            "patch_embeds": _meta((b, cfg.num_patches, cfg.d_model), _F32),
        }
    if cfg.family == "encdec":
        return {
            "tokens": _meta((b, s), _I32),
            "labels": _meta((b, s), _I32),
            "enc_embeds": _meta((b, cfg.encoder_len, cfg.d_model), _F32),
        }
    return {"tokens": _meta((b, s), _I32), "labels": _meta((b, s), _I32)}


_BATCH_AXES = {
    "tokens": ("batch", None),
    "labels": ("batch", None),
    "loss_weights": ("batch", None),
    "patch_embeds": ("batch", None, None),
    "enc_embeds": ("batch", None, None),
    "images": ("batch", "height", "width"),
    "positions": ("batch", None),
    "cache_positions": ("batch", None),
}


def batch_logical_axes(batch: Dict[str, Any]) -> Dict[str, Tuple]:
    return {k: _BATCH_AXES[k] for k in batch}


def cache_logical_axes(cfg: ModelConfig, model_axis_size: int) -> Dict[str, Any]:
    """Logical axes mirroring ``Model.init_cache``'s structure.

    KV caches shard heads over `model` when divisible, otherwise fall back to
    flash-decoding-style *length* sharding.
    """
    def attn(stack_axis: str):
        if cfg.attn_type == "mla":
            return {
                "ckv": (stack_axis, "batch", None, "kv_rank"),
                "k_rope": (stack_axis, "batch", None, None),
            }
        if cfg.num_kv_heads % model_axis_size == 0:
            kv = (stack_axis, "batch", None, "kv_heads", None)
        else:
            kv = (stack_axis, "batch", "kv_len", None, None)
        return {"k": kv, "v": kv}

    if cfg.family in ("dense", "moe", "vlm"):
        return {"layers": attn("layers")}
    if cfg.family == "ssm":
        return {
            "layers": {
                "h": ("layers", "batch", "ssm_inner", None),
                "conv": ("layers", "batch", None, "ssm_inner"),
            }
        }
    if cfg.family == "hybrid":
        return {
            "layers": {
                "h": ("layers", "batch", "ssm_heads", None, None),
                "conv": ("layers", "batch", None, None),
            },
            "shared": attn("stack"),
        }
    if cfg.family == "encdec":
        return {
            "layers": attn("layers"),
            "cross_k": ("layers", "batch", None, "heads", None),
            "cross_v": ("layers", "batch", None, "heads", None),
        }
    raise ValueError(cfg.family)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16):
    """``Model.init_cache`` on the ``meta`` device: the cache's tree of
    shapes and dtypes, no memory."""
    return Model(cfg).init_cache(batch, max_len, dtype=dtype, device=_META)
