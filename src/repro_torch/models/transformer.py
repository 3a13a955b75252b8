"""Transformer assembly for the dense, moe and ssm families: embed, a loop
over the stacked layers, final norm, unembed.

The port of ``repro.models.transformer`` for ``dense`` (pre-norm
[attention, MLP] blocks, RoPE, causal; GQA or MLA), ``moe`` (the same with
the MoE FFN of ``models/moe.py``) and ``ssm`` (pre-norm [Mamba-1] blocks,
attention-free). The reference's ``lax.scan`` over the stacked parameters
is a Python loop over the leading layer axis here; remat is a training
matter and is not ported. The other families (hybrid, encdec, vlm) raise,
naming their ROADMAP item. A moe model's forward returns the per-layer
auxiliary losses summed over the layers (``moe_aux``, ``moe_z``); its
prefill and decode step drop them, as the reference's do.

Every function takes ``backend`` (``auto`` | ``cuda`` | ``torch``) and hands
it to ``attention.apply_attention`` or ``ssm.apply_mamba1``: on a CUDA
tensor ``auto`` runs the prefill and forward attention through kernel K4
and the prefill and forward scan through kernel K5.

Caches are written in place, a layer at a time: the attention families'
k/v (MLA: the latent and the rope key) at the prefill's and decode's
positions, the ssm family's state ``h`` and conv tail (the reference
returns new caches). An ssm model keeps no positions: its prefill starts
every sequence from the zero state, and its decode step ignores
``index``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import UNPORTED, ModelConfig
from repro_torch.models import ssm
from repro_torch.models.attention import apply_attention, attention_params, init_attn_cache
from repro_torch.models.layers import (
    Spec,
    apply_mlp,
    apply_norm,
    mlp_params,
    norm_params,
    stack_specs,
    torch_dtype,
)
from repro_torch.models.moe import apply_moe, moe_params

__all__ = [
    "model_param_specs",
    "forward",
    "prefill",
    "decode_step",
    "init_cache",
    "embed_tokens",
    "unembed",
    "check_family",
]


def check_family(cfg: ModelConfig) -> None:
    """Raise for a family the port does not run yet, naming its ROADMAP item."""
    if cfg.family in ("dense", "moe", "ssm"):
        return
    if cfg.family in UNPORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: ROADMAP {UNPORTED[cfg.family]}")
    raise ValueError(f"{cfg.name!r} is family {cfg.family!r}, not a language model")


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor, dtype) -> torch.Tensor:
    table = params["embed"]["embedding"].to(dtype)
    return table[tokens.long()]


def unembed(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return x @ params["embed"]["lm_head"].to(x.dtype)


# ---------------------------------------------------------------------------
# Per-layer specs
# ---------------------------------------------------------------------------

def _attn_layer_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "ln1": norm_params(cfg),
        "attn": attention_params(cfg),
        "ln2": norm_params(cfg),
        "ffn": moe_params(cfg) if cfg.family == "moe" else mlp_params(cfg),
    }


def _layer_specs(cfg: ModelConfig) -> Dict[str, Any]:
    if cfg.family == "ssm":
        return {"ln": norm_params(cfg), "mamba": ssm.mamba1_params(cfg)}
    return _attn_layer_specs(cfg)


def model_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    check_family(cfg)
    return {
        "embed": {
            "embedding": Spec((cfg.vocab_size, cfg.d_model), ("table_vocab", "embed_td"), "normal"),
            "lm_head": Spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab")),
        },
        "layers": stack_specs(_layer_specs(cfg), cfg.num_layers),
        "final_norm": norm_params(cfg),
    }


def _layer(tree: Any, i: int) -> Any:
    """Layer ``i`` of a tree of tensors stacked on the leading axis (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _apply_attn_block(lp, cfg: ModelConfig, x, positions, *, causal=True, cache=None,
                      index=None, backend="auto"):
    """One pre-norm [attention, MLP or MoE] block. Returns (x, new cache or
    None, the MoE's auxiliary losses or {})."""
    h, new_cache = apply_attention(
        lp["attn"], cfg, apply_norm(lp["ln1"], cfg, x), positions,
        causal=causal, cache=cache, cache_index=index, backend=backend,
    )
    x = x + h
    y = apply_norm(lp["ln2"], cfg, x)
    if cfg.family == "moe":
        h, aux = apply_moe(lp["ffn"], cfg, y)
    else:
        h, aux = apply_mlp(lp["ffn"], cfg, y), {}
    return x + h, new_cache, aux


def _apply_mamba_block(lp, cfg: ModelConfig, x, *, cache=None, return_cache=False,
                       backend="auto"):
    """One pre-norm Mamba-1 block: decode one token against ``cache``, or
    run the prefill forward (K5 on the card), with its new cache when
    ``return_cache``. Returns (x, new cache or None)."""
    y = apply_norm(lp["ln"], cfg, x)
    if cache is not None:
        h, new_cache = ssm.mamba1_decode(lp["mamba"], cfg, y, cache)
        return x + h, new_cache
    if return_cache:
        h, new_cache = ssm.apply_mamba1(lp["mamba"], cfg, y, return_cache=True, backend=backend)
        return x + h, new_cache
    return x + ssm.apply_mamba1(lp["mamba"], cfg, y, backend=backend), None


def _scan_decoder(params, cfg: ModelConfig, x, positions, backend="auto"):
    """The main layer stack without a cache (the reference's ``lax.scan``).
    Returns (x, the auxiliary losses summed over the layers)."""
    auxs: Dict[str, list] = {}
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        if cfg.family == "ssm":
            x, _ = _apply_mamba_block(lp, cfg, x, backend=backend)
            continue
        x, _, aux = _apply_attn_block(lp, cfg, x, positions, causal=True, backend=backend)
        for name, v in aux.items():
            auxs.setdefault(name, []).append(v)
    # the reference sums each loss over its scan's stacked per-layer values
    return x, {name: torch.stack(vs).sum() for name, vs in auxs.items()}


def _prepare_inputs(params, cfg: ModelConfig, batch: Dict, dtype):
    """tokens -> (x, positions); positions default to arange(S) in every row.
    An ssm model takes no positions: they come back None."""
    tokens = batch["tokens"]
    x = embed_tokens(params, cfg, tokens, dtype)
    if cfg.family == "ssm":
        return x, None
    b, s = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    return x, positions


def forward(params, cfg: ModelConfig, batch: Dict, *,
            backend: str = "auto") -> Tuple[torch.Tensor, Dict]:
    """Full (prefill-style) forward. Returns (logits, aux_losses): a moe
    model's ``moe_aux`` and ``moe_z`` summed over its layers, ``{}`` for a
    dense or ssm model."""
    check_family(cfg)
    x, positions = _prepare_inputs(params, cfg, batch, torch_dtype(cfg.dtype))
    x, aux = _scan_decoder(params, cfg, x, positions, backend)
    x = apply_norm(params["final_norm"], cfg, x)
    return unembed(params, cfg, x), aux


# ---------------------------------------------------------------------------
# KV-cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> Dict:
    """``{"layers": {"k", "v"}}`` (GQA), ``{"layers": {"ckv", "k_rope"}}``
    (MLA) or ``{"layers": {"h", "conv"}}`` (ssm: ``max_len`` unused, ``h``
    always f32) zeros with a leading layer axis, on ``device`` (``None`` =
    the CUDA device)."""
    check_family(cfg)
    if cfg.family == "ssm":
        one = ssm.init_mamba1_cache(cfg, batch, dtype, device)
    else:
        one = init_attn_cache(cfg, batch, max_len, dtype, device)
    return {"layers": {name: torch.zeros((cfg.num_layers,) + a.shape, dtype=a.dtype,
                                         device=a.device)
                       for name, a in one.items()}}


def _ssm_stack(params, cfg: ModelConfig, x, cache: Dict, *, decode: bool, backend):
    """The Mamba-1 stack with a cache: each layer's new state and conv tail
    are written into the stacked cache in place (cast to its dtypes)."""
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        if decode:
            x, new = _apply_mamba_block(lp, cfg, x, cache=_layer(cache["layers"], i))
        else:
            x, new = _apply_mamba_block(lp, cfg, x, return_cache=True, backend=backend)
        for name, t in new.items():
            cache["layers"][name][i].copy_(t)
    return x


def _cached_stack(params, cfg: ModelConfig, x, positions, cache: Dict, index, backend):
    for i in range(cfg.num_layers):
        x, _, _ = _apply_attn_block(_layer(params["layers"], i), cfg, x, positions,
                                    causal=True, cache=_layer(cache["layers"], i), index=index,
                                    backend=backend)
    return x


def prefill(params, cfg: ModelConfig, batch: Dict, cache: Dict, *,
            backend: str = "auto") -> Tuple[torch.Tensor, Dict]:
    """Process a prompt, filling the cache (in place) from position 0, or at
    ``batch["cache_positions"]`` per token (dense, moe); an ssm prompt runs from
    the zero state and writes each layer's final state and conv tail.
    Returns (last-position logits, cache)."""
    check_family(cfg)
    x, positions = _prepare_inputs(params, cfg, batch, torch_dtype(cfg.dtype))
    if cfg.family == "ssm":
        x = _ssm_stack(params, cfg, x, cache, decode=False, backend=backend)
    else:
        # Engine path: per-token cache destinations (pad tokens -> trash slot).
        index = batch.get("cache_positions", 0)
        x = _cached_stack(params, cfg, x, positions, cache, index, backend)
    x = apply_norm(params["final_norm"], cfg, x)
    return unembed(params, cfg, x[:, -1:, :]), cache


def decode_step(params, cfg: ModelConfig, cache: Dict, tokens: torch.Tensor, index, *,
                backend: str = "auto") -> Tuple[torch.Tensor, Dict]:
    """One token for every sequence. tokens: (B, 1); index: a scalar
    position or (B,) per-slot positions (unused by an ssm model). Writes
    the cache in place."""
    check_family(cfg)
    x = embed_tokens(params, cfg, tokens, torch_dtype(cfg.dtype))
    if cfg.family == "ssm":
        x = _ssm_stack(params, cfg, x, cache, decode=True, backend=backend)
    else:
        b = tokens.shape[0]
        index = torch.as_tensor(index, device=x.device)
        if index.ndim == 0:
            positions = torch.full((b, 1), int(index), dtype=torch.int32, device=x.device)
        else:                      # per-slot positions (continuous batching)
            positions = index.to(torch.int32)[:, None]
        x = _cached_stack(params, cfg, x, positions, cache, index, backend)
    x = apply_norm(params["final_norm"], cfg, x)
    return unembed(params, cfg, x), cache
