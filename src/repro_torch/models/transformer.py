"""Transformer assembly for every LM family: embed, a loop over the stacked
layers, final norm, unembed.

The port of ``repro.models.transformer``. Families:
  dense / moe / vlm : pre-norm [attention, MLP or MoE] blocks, RoPE, causal
                      (GQA or MLA); a VLM prepends the stub frontend's
                      ``patch_embeds`` to the text embeddings and attends
                      over both;
  ssm (mamba1)      : pre-norm [Mamba-1] blocks, attention-free;
  hybrid (zamba2)   : a Mamba-2 backbone plus ONE shared attention block
                      applied after every ``attn_every`` Mamba-2 layers
                      (zamba2: 54 / 6 = 9 applications of one set of
                      weights, each with its own cache);
  encdec (whisper)  : a bidirectional encoder over the stub frontend's
                      ``enc_embeds`` and a causal decoder with
                      cross-attention; sinusoidal positions added to both
                      stacks' inputs (no RoPE).

The reference's ``lax.scan`` over the stacked parameters (nested, outer
over the hybrid's groups) is a Python loop over the leading layer axis
here. Its remat is :mod:`~repro_torch.models.remat`: the forward and
:func:`mesh_forward` run each of :func:`remat_units` (a block, an encoder
layer, a hybrid group) through ``remat.unit``, which checkpoints it under
autograd as the config's ``remat`` and ``remat_policy`` say. A moe model's
forward returns the per-layer auxiliary losses summed over the layers
(``moe_aux``, ``moe_z``); its prefill and decode step drop them, as the
reference's do.

Every function takes ``backend`` (``auto`` | ``cuda`` | ``torch``) and hands
it to ``attention.apply_attention``, ``attention.apply_cross_attention`` or
``ssm.apply_mamba1``: on a CUDA tensor ``auto`` runs every prefill and
forward attention through kernel K4 (the encoder's and the cross-attention
non-causal) and the Mamba-1 prefill and forward scan through kernel K5.
Mamba-2's SSD is plain PyTorch on both lanes, as the reference's is XLA.

Caches are written in place, a layer at a time: the attention families'
k/v (MLA: the latent and the rope key) at the prefill's and decode's
positions, the ssm and hybrid families' state ``h`` and conv tail, the
hybrid's shared-block k/v per application (``shared``). An encdec prefill
replaces the cache's ``cross_k``/``cross_v`` with the encoder's keys and
values, as long as the encoder's input (the reference's prefill does the
same), so the decode step never reads keys past it. An ssm model keeps no
positions: its prefill starts every sequence from the zero state, and its
decode step ignores ``index``; a hybrid prefill starts its Mamba-2 layers
from the zero state too.

:func:`mesh_forward` is the forward on a mesh, for training, of every
family (dense with GQA or MLA, moe, ssm, hybrid, encdec, vlm): the
reference jits its forward with the train rules' shardings and lets GSPMD
split it; the port runs each mesh position's shard itself (FSDP
all-gathers, tensor-parallel attention, cross-attention and MLP with their
all-reduces over ``model``, expert-parallel MoE, Mamba-1 on each
position's channels and Mamba-2 on its heads, vocab-parallel logits) and
calls K4 on each position's own heads and K5 on its own channels.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import remat, ssm
from repro_torch.models.attention import (
    apply_attention,
    apply_cross_attention,
    attention_params,
    cross_attention_params,
    cross_kv,
    init_attn_cache,
)
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
    "Block",
    "block_plan",
    "remat_units",
    "mesh_block",
    "mesh_embed",
    "mesh_encode",
    "mesh_unembed",
    "mesh_forward",
    "LM_FAMILIES",
]

LM_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def check_family(cfg: ModelConfig) -> None:
    """Raise for a config that is not a language model."""
    if cfg.family not in LM_FAMILIES:
        raise ValueError(f"{cfg.name!r} is family {cfg.family!r}, not a language model")


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor, dtype) -> torch.Tensor:
    table = params["embed"]["embedding"].to(dtype)
    return table[tokens.long()]


def unembed(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return x @ params["embed"]["lm_head"].to(x.dtype)


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(B, S) -> (B, S, d) sinusoidal embedding (whisper-style), f32."""
    half = d // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(10000.0) * idx / max(1, half - 1))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Per-layer specs
# ---------------------------------------------------------------------------

def _attn_layer_specs(cfg: ModelConfig, moe: bool, cross: bool = False) -> Dict[str, Any]:
    lp: Dict[str, Any] = {
        "ln1": norm_params(cfg),
        "attn": attention_params(cfg),
        "ln2": norm_params(cfg),
        "ffn": moe_params(cfg) if moe else mlp_params(cfg),
    }
    if cross:
        lp["ln_x"] = norm_params(cfg)
        lp["cross"] = cross_attention_params(cfg)
    return lp


def _layer_specs(cfg: ModelConfig) -> Dict[str, Any]:
    if cfg.family == "ssm":
        return {"ln": norm_params(cfg), "mamba": ssm.mamba1_params(cfg)}
    if cfg.family == "hybrid":
        return {"ln": norm_params(cfg), "mamba": ssm.mamba2_params(cfg)}
    return _attn_layer_specs(cfg, moe=cfg.family == "moe", cross=cfg.family == "encdec")


def model_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    check_family(cfg)
    specs: Dict[str, Any] = {
        "embed": {
            "embedding": Spec((cfg.vocab_size, cfg.d_model), ("table_vocab", "embed_td"), "normal"),
            "lm_head": Spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab")),
        },
        "layers": stack_specs(_layer_specs(cfg), cfg.num_layers),
        "final_norm": norm_params(cfg),
    }
    if cfg.family == "hybrid":
        specs["shared"] = _attn_layer_specs(cfg, moe=False)
    if cfg.family == "encdec":
        specs["encoder"] = {
            "layers": stack_specs(_attn_layer_specs(cfg, moe=False), cfg.encoder_layers),
            "final_norm": norm_params(cfg),
        }
    return specs


def _layer(tree: Any, i: int) -> Any:
    """Layer ``i`` of a tree of tensors stacked on the leading axis (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _layers(tree: Any, n: int) -> list:
    """Every layer of a stacked tree, as ``_layer`` gives them, cut with one
    ``unbind`` a leaf. Under autograd the leaf's gradient is then one
    ``stack`` of the layers' gradients; indexing layer by layer would
    make each layer's gradient a zero-filled copy of the whole stack and
    add the n copies up."""
    if isinstance(tree, dict):
        per_key = {k: _layers(v, n) for k, v in tree.items()}
        return [{k: per_key[k][i] for k in tree} for i in range(n)]
    if tree.shape[0] != n:
        raise ValueError(f"a stacked leaf of {tree.shape[0]} layers, not {n}")
    return list(torch.unbind(tree, 0))


def _groups(cfg: ModelConfig) -> int:
    """The hybrid's groups: ``attn_every`` Mamba-2 layers, then the shared block."""
    if cfg.attn_every <= 0 or cfg.num_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: num_layers={cfg.num_layers} is not a multiple of "
                         f"attn_every={cfg.attn_every}")
    return cfg.num_layers // cfg.attn_every


class Block(NamedTuple):
    """One block of a forward, as :func:`block_plan` lists it."""
    stream: str                 # "enc": an encoder's block; "dec": any other
    layer: Union[int, str]      # its index in its stream's stacked ``layers``, or "shared"
    causal: bool


def block_plan(cfg: ModelConfig, stream: Optional[str] = None) -> list:
    """Every block of one forward, in order (only ``stream``'s where given):
    an encdec model's encoder layers, non-causal, before its decoder
    layers; the hybrid's ``attn_every`` Mamba-2 layers, then the shared
    block, once a group; one block a layer for the other families. The one
    schedule that the single-device stacks, :func:`mesh_forward` and
    :func:`mesh_encode` walk."""
    if cfg.family == "hybrid":
        _groups(cfg)
    plan = [Block("enc", i, False) for i in range(cfg.encoder_layers)
            if cfg.family == "encdec"]
    for i in range(cfg.num_layers):
        plan.append(Block("dec", i, True))
        if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
            plan.append(Block("dec", "shared", True))
    return [b for b in plan if stream in (None, b.stream)]


def remat_units(cfg: ModelConfig, stream: Optional[str] = None) -> list:
    """:func:`block_plan` cut into the units that remat checkpoints, the
    reference's: one block each, but the hybrid's group (its ``attn_every``
    Mamba-2 layers and then the shared block) is one unit."""
    units: list = []
    for blk in block_plan(cfg, stream):
        if units and cfg.family == "hybrid" and units[-1][-1].layer != "shared":
            units[-1].append(blk)
        else:
            units.append([blk])
    return units


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _apply_attn_block(lp, cfg: ModelConfig, x, positions, *, causal=True, cache=None,
                      index=None, enc_kv=None, backend="auto"):
    """One pre-norm [attention, (cross-attention over ``enc_kv``,) MLP or
    MoE] block. Returns (x, new cache or None, the MoE's auxiliary losses
    or {})."""
    h, new_cache = apply_attention(
        lp["attn"], cfg, apply_norm(lp["ln1"], cfg, x), positions,
        causal=causal, cache=cache, cache_index=index, backend=backend,
    )
    x = x + h
    if enc_kv is not None:
        x = x + apply_cross_attention(lp["cross"], cfg, apply_norm(lp["ln_x"], cfg, x), *enc_kv,
                                      backend=backend)
    y = apply_norm(lp["ln2"], cfg, x)
    if cfg.family == "moe":
        h, aux = apply_moe(lp["ffn"], cfg, y)
    else:
        h, aux = apply_mlp(lp["ffn"], cfg, y), {}
    return x + h, new_cache, aux


def _apply_mamba_block(lp, cfg: ModelConfig, x, *, cache=None, return_cache=False,
                       backend="auto"):
    """One pre-norm Mamba block (Mamba-1 for the ssm family, Mamba-2 for the
    hybrid): decode one token against ``cache``, or run the prefill forward
    (Mamba-1's scan on K5 on the card), with its new cache when
    ``return_cache``. Returns (x, new cache or None)."""
    y = apply_norm(lp["ln"], cfg, x)
    mamba1 = cfg.family == "ssm"
    if cache is not None:
        dec = ssm.mamba1_decode if mamba1 else ssm.mamba2_decode
        h, new_cache = dec(lp["mamba"], cfg, y, cache)
        return x + h, new_cache
    if mamba1:
        out = ssm.apply_mamba1(lp["mamba"], cfg, y, return_cache=return_cache, backend=backend)
    else:
        out = ssm.apply_mamba2(lp["mamba"], cfg, y, return_cache=return_cache)
    if return_cache:
        h, new_cache = out
        return x + h, new_cache
    return x + out, None


def _run_unit(blocks, cfg: ModelConfig, backend, x, lps, positions, enc_out):
    """The blocks of one remat unit, in order, on x (no cache). Returns (x,
    the unit's auxiliary losses: a list of values by name)."""
    auxs: Dict[str, list] = {}
    for blk, lp in zip(blocks, lps):
        if "mamba" in lp:
            x, _ = _apply_mamba_block(lp, cfg, x, backend=backend)
            continue
        enc_kv = cross_kv(lp["cross"], cfg, enc_out) if "cross" in lp else None
        x, _, aux = _apply_attn_block(lp, cfg, x, positions, causal=blk.causal, enc_kv=enc_kv,
                                      backend=backend)
        for name, v in aux.items():
            auxs.setdefault(name, []).append(v)
    return x, auxs


def _scan_decoder(params, cfg: ModelConfig, x, positions, enc_out=None, backend="auto"):
    """The main layer stack without a cache (the reference's ``lax.scan``),
    a remat unit at a time. Returns (x, the auxiliary losses summed over
    the layers)."""
    layers = _layers(params["layers"], cfg.num_layers)
    auxs: Dict[str, list] = {}
    for blocks in remat_units(cfg, "dec"):
        lps = [params["shared"] if blk.layer == "shared" else layers[blk.layer] for blk in blocks]
        x, aux = remat.unit(functools.partial(_run_unit, blocks, cfg, backend), cfg, x, lps,
                            positions, enc_out)
        for name, vs in aux.items():
            auxs.setdefault(name, []).extend(vs)
    # the reference sums each loss over its scan's stacked per-layer values
    return x, {name: torch.stack(vs).sum() for name, vs in auxs.items()}


def _prepare_inputs(params, cfg: ModelConfig, batch: Dict, dtype):
    """tokens (and a VLM's ``patch_embeds``, prepended) -> (x, positions);
    positions default to arange over every position in every row, and an
    encdec model's sinusoid is added to x. An ssm model takes no
    positions: they come back None."""
    tokens = batch["tokens"]
    x = embed_tokens(params, cfg, tokens, dtype)
    if cfg.family == "vlm" and cfg.frontend == "vision_stub":
        x = torch.cat([batch["patch_embeds"].to(dtype), x], dim=1)      # (B, P + S, d)
    if cfg.family == "ssm":
        return x, None
    b, s = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    if cfg.family == "encdec":
        x = x + _sinusoid(positions, cfg.d_model).to(dtype)
    return x, positions


def _encode(params, cfg: ModelConfig, enc_embeds: torch.Tensor, dtype, backend="auto"):
    """The bidirectional encoder over (B, T, d_model) frame embeddings (K4
    non-causal on the card). Returns its normed output."""
    b, t, _ = enc_embeds.shape
    pos = torch.arange(t, dtype=torch.int32, device=enc_embeds.device)[None].expand(b, t)
    x = enc_embeds.to(dtype) + _sinusoid(pos, cfg.d_model).to(dtype)
    enc = params["encoder"]
    layers = _layers(enc["layers"], cfg.encoder_layers)
    for blocks in remat_units(cfg, "enc"):
        x, _ = remat.unit(functools.partial(_run_unit, blocks, cfg, backend), cfg, x,
                          [layers[blk.layer] for blk in blocks], pos, None)
    return apply_norm(enc["final_norm"], cfg, x)


def forward(params, cfg: ModelConfig, batch: Dict, *,
            backend: str = "auto") -> Tuple[torch.Tensor, Dict]:
    """Full (prefill-style) forward over every position (a VLM's patches
    included). Returns (logits, aux_losses): a moe model's ``moe_aux`` and
    ``moe_z`` summed over its layers, ``{}`` for the other families."""
    check_family(cfg)
    dtype = torch_dtype(cfg.dtype)
    enc_out = (_encode(params, cfg, batch["enc_embeds"], dtype, backend)
               if cfg.family == "encdec" else None)
    x, positions = _prepare_inputs(params, cfg, batch, dtype)
    x, aux = _scan_decoder(params, cfg, x, positions, enc_out, backend)
    x = apply_norm(params["final_norm"], cfg, x)
    return unembed(params, cfg, x), aux


# ---------------------------------------------------------------------------
# KV-cache init / prefill / decode
# ---------------------------------------------------------------------------

def _stacked_zeros(n: int, one: Dict) -> Dict:
    return {name: torch.zeros((n,) + a.shape, dtype=a.dtype, device=a.device)
            for name, a in one.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> Dict:
    """Zeros with a leading layer axis, on ``device`` (``None`` = the CUDA
    device): ``{"layers": {"k", "v"}}`` (GQA), ``{"layers": {"ckv",
    "k_rope"}}`` (MLA), ``{"layers": {"h", "conv"}}`` (ssm: ``max_len``
    unused, ``h`` always f32); the hybrid's Mamba-2 ``layers`` beside
    ``shared`` (the shared block's k/v, one per group); an encdec model's
    ``layers`` beside ``cross_k``/``cross_v`` of ``encoder_len`` frames."""
    check_family(cfg)
    if cfg.family == "ssm":
        return {"layers": _stacked_zeros(cfg.num_layers,
                                         ssm.init_mamba1_cache(cfg, batch, dtype, device))}
    if cfg.family == "hybrid":
        return {
            "layers": _stacked_zeros(cfg.num_layers,
                                     ssm.init_mamba2_cache(cfg, batch, dtype, device)),
            "shared": _stacked_zeros(_groups(cfg),
                                     init_attn_cache(cfg, batch, max_len, dtype, device)),
        }
    cache = {"layers": _stacked_zeros(cfg.num_layers,
                                      init_attn_cache(cfg, batch, max_len, dtype, device))}
    if cfg.family == "encdec":
        shape = (cfg.num_layers, batch, cfg.encoder_len, cfg.num_heads, cfg.head_dim)
        dev = cache["layers"]["k"].device
        cache["cross_k"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["cross_v"] = torch.zeros(shape, dtype=dtype, device=dev)
    return cache


def _mamba_layer(params, cfg: ModelConfig, x, cache: Dict, i: int, *, decode: bool, backend):
    """Mamba layer ``i`` with a cache: its new state and conv tail are
    written into the stacked cache in place (cast to its dtypes)."""
    lp = _layer(params["layers"], i)
    if decode:
        x, new = _apply_mamba_block(lp, cfg, x, cache=_layer(cache["layers"], i))
    else:
        x, new = _apply_mamba_block(lp, cfg, x, return_cache=True, backend=backend)
    for name, t in new.items():
        cache["layers"][name][i].copy_(t)
    return x


def _ssm_stack(params, cfg: ModelConfig, x, cache: Dict, *, decode: bool, backend):
    for i in range(cfg.num_layers):
        x = _mamba_layer(params, cfg, x, cache, i, decode=decode, backend=backend)
    return x


def _hybrid_stack(params, cfg: ModelConfig, x, positions, cache: Dict, index, *,
                  decode: bool, backend):
    """The hybrid's groups with a cache: each group's Mamba-2 layers, then
    the shared block with group ``g``'s k/v cache."""
    g = 0
    for blk in block_plan(cfg):
        if blk.layer != "shared":
            x = _mamba_layer(params, cfg, x, cache, blk.layer, decode=decode, backend=backend)
            continue
        x, _, _ = _apply_attn_block(params["shared"], cfg, x, positions, causal=blk.causal,
                                    cache=_layer(cache["shared"], g), index=index,
                                    backend=backend)
        g += 1
    return x


def _cached_stack(params, cfg: ModelConfig, x, positions, cache: Dict, index, backend,
                  enc_out=None):
    """The attention families' stack with a cache. An encdec prefill
    (``enc_out`` given) projects each layer's cross k/v from the encoder's
    output and replaces the cache's with them; an encdec decode step reads
    them from the cache."""
    cross = {"cross_k": [], "cross_v": []}
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        enc_kv = None
        if cfg.family == "encdec" and enc_out is not None:
            enc_kv = cross_kv(lp["cross"], cfg, enc_out)
            cross["cross_k"].append(enc_kv[0])
            cross["cross_v"].append(enc_kv[1])
        elif cfg.family == "encdec":
            enc_kv = (cache["cross_k"][i], cache["cross_v"][i])
        x, _, _ = _apply_attn_block(lp, cfg, x, positions, causal=True,
                                    cache=_layer(cache["layers"], i), index=index,
                                    enc_kv=enc_kv, backend=backend)
    for name, ts in cross.items():
        if ts:
            cache[name] = torch.stack(ts).to(cache[name].dtype)
    return x


def prefill(params, cfg: ModelConfig, batch: Dict, cache: Dict, *,
            backend: str = "auto") -> Tuple[torch.Tensor, Dict]:
    """Process a prompt, filling the cache (in place) from position 0, or at
    ``batch["cache_positions"]`` per token (the attention families); an ssm
    or hybrid prompt's Mamba layers run from the zero state and write each
    layer's final state and conv tail; an encdec prompt also encodes
    ``batch["enc_embeds"]`` into the cache's cross k/v. Returns
    (last-position logits, cache)."""
    check_family(cfg)
    dtype = torch_dtype(cfg.dtype)
    enc_out = (_encode(params, cfg, batch["enc_embeds"], dtype, backend)
               if cfg.family == "encdec" else None)
    x, positions = _prepare_inputs(params, cfg, batch, dtype)
    # Engine path: per-token cache destinations (pad tokens -> trash slot).
    index = batch.get("cache_positions", 0)
    if cfg.family == "ssm":
        x = _ssm_stack(params, cfg, x, cache, decode=False, backend=backend)
    elif cfg.family == "hybrid":
        x = _hybrid_stack(params, cfg, x, positions, cache, index, decode=False,
                          backend=backend)
    else:
        x = _cached_stack(params, cfg, x, positions, cache, index, backend, enc_out)
    x = apply_norm(params["final_norm"], cfg, x)
    return unembed(params, cfg, x[:, -1:, :]), cache


def decode_step(params, cfg: ModelConfig, cache: Dict, tokens: torch.Tensor, index, *,
                backend: str = "auto") -> Tuple[torch.Tensor, Dict]:
    """One token for every sequence. tokens: (B, 1); index: a scalar
    position or (B,) per-slot positions (unused by an ssm model). Writes
    the cache in place."""
    check_family(cfg)
    dtype = torch_dtype(cfg.dtype)
    x = embed_tokens(params, cfg, tokens, dtype)
    if cfg.family == "ssm":
        x = _ssm_stack(params, cfg, x, cache, decode=True, backend=backend)
    else:
        b = tokens.shape[0]
        index = torch.as_tensor(index, device=x.device)
        if index.ndim == 0:
            positions = torch.full((b, 1), int(index), dtype=torch.int32, device=x.device)
        else:                      # per-slot positions (continuous batching)
            positions = index.to(torch.int32)[:, None]
        if cfg.family == "encdec":
            x = x + _sinusoid(positions, cfg.d_model).to(dtype)
        if cfg.family == "hybrid":
            x = _hybrid_stack(params, cfg, x, positions, cache, index, decode=True,
                              backend=backend)
        else:
            x = _cached_stack(params, cfg, x, positions, cache, index, backend)
    x = apply_norm(params["final_norm"], cfg, x)
    return unembed(params, cfg, x), cache


# ---------------------------------------------------------------------------
# On a mesh (training): every family
# ---------------------------------------------------------------------------

def _model_split(leaf, dim: int) -> bool:
    return leaf.spec.axes(dim) == ("model",)


def _position_weights(params, mesh, dtype, active) -> Dict[Any, Any]:
    """Each active position's weights: a leaf's dims split over a mesh axis
    other than ``model`` (FSDP's ``data``) are all-gathered in f32, then
    every f32 leaf is cast to ``dtype`` (``Model.cast_params``); dims split
    over ``model`` stay the position's own slice. Returns ``{position:
    parameter tree}``."""
    from repro_torch.sharding.placed import all_gather
    from repro_torch.tree import leaves, unflatten

    per_leaf = []
    for leaf in leaves(params):
        vals = dict(leaf.shards)
        for dim in range(leaf.ndim):
            axes = leaf.spec.axes(dim)
            if not axes or axes == ("model",):
                continue
            if "model" in axes:
                raise NotImplementedError(f"a dim split over {axes}: the mesh forward gathers "
                                          "every axis but model, and keeps model's slices")
            vals = all_gather(vals, mesh, axes, dim)
        per_leaf.append({pos: vals[pos].to(dtype) if vals[pos].dtype == torch.float32
                         else vals[pos] for pos in active})
    return {pos: unflatten(params, [d[pos] for d in per_leaf]) for pos in active}


def mesh_block(lps: Dict[Any, Any], cfg: ModelConfig, x: Dict[Any, torch.Tensor],
               pos_ids: Dict[Any, torch.Tensor], mesh, *, causal: bool = True,
               enc: Optional[Dict[Any, torch.Tensor]] = None,
               backend: str = "auto") -> Tuple[Dict[Any, torch.Tensor], Dict[str, torch.Tensor]]:
    """One pre-norm block on a mesh. ``lps`` holds each position's weights
    of the block (its own heads', ``mlp`` columns, experts or
    ``ssm_inner`` channels where ``model`` splits them, the rest whole:
    what :func:`_position_weights` gives), ``x`` each position's copy of
    its batch shard's hidden state. Which weights are split is read from
    their shapes. A Mamba block: ``ssm.mamba1_mesh`` (the ssm family, K5
    once a position on the card) or ``ssm.mamba2_mesh`` (the hybrid's
    backbone, each position on its own heads). An attention block (the
    dense, moe, vlm and encdec families and the hybrid's shared block):
    tensor-parallel self-attention (``attention.attention_mesh``: K4 once a
    position on the card, non-causal where ``causal`` is False, as in an
    encoder), then, where ``enc`` holds each position's encoder output
    (an encdec decoder), ``ln_x`` and the tensor-parallel cross-attention
    over it (``attention.cross_attention_mesh``, K4 non-causal), then the
    tensor-parallel MLP (a split ``mlp`` dim means a row-parallel
    ``w_down`` summed over ``model``) or the expert-parallel MoE
    (``moe.moe_mesh``), as :func:`_apply_attn_block` orders them. Returns
    (each position's block output, the MoE's aux losses on the mesh's
    lead device, ``{}`` for the others)."""
    from repro_torch.models.attention import attention_mesh, cross_attention_mesh
    from repro_torch.models.moe import moe_mesh
    from repro_torch.sharding.placed import all_reduce

    if "mamba" in next(iter(lps.values())):
        normed = {pos: apply_norm(lp["ln"], cfg, x[pos]) for pos, lp in lps.items()}
        mambas = {pos: lp["mamba"] for pos, lp in lps.items()}
        if cfg.family == "ssm":
            part = ssm.mamba1_mesh(mambas, cfg, normed, mesh, backend=backend)
        else:
            part = ssm.mamba2_mesh(mambas, cfg, normed, mesh)
        return {pos: x[pos] + part[pos] for pos in lps}, {}
    part = attention_mesh({pos: lp["attn"] for pos, lp in lps.items()}, cfg,
                          {pos: apply_norm(lp["ln1"], cfg, x[pos]) for pos, lp in lps.items()},
                          pos_ids, mesh, causal=causal, backend=backend)
    x = {pos: x[pos] + part[pos] for pos in lps}
    if enc is not None:
        part = cross_attention_mesh({pos: lp["cross"] for pos, lp in lps.items()}, cfg,
                                    {pos: apply_norm(lp["ln_x"], cfg, x[pos])
                                     for pos, lp in lps.items()}, enc, mesh, backend=backend)
        x = {pos: x[pos] + part[pos] for pos in lps}
    y = {pos: apply_norm(lp["ln2"], cfg, x[pos]) for pos, lp in lps.items()}
    aux: Dict[str, torch.Tensor] = {}
    if cfg.family == "moe":
        part, aux = moe_mesh({pos: lp["ffn"] for pos, lp in lps.items()}, cfg, y, mesh)
    else:
        part = {pos: apply_mlp(lp["ffn"], cfg, y[pos]) for pos, lp in lps.items()}
        if any(lp["ffn"]["w_down"].shape[0] < cfg.d_ff for lp in lps.values()):
            part = all_reduce(part, mesh, "model")
    return {pos: x[pos] + part[pos] for pos in lps}, aux


def _mesh_unit(blocks, cfg: ModelConfig, mesh, backend, x, lps, pos_ids, enc):
    """The blocks of one remat unit on a mesh (:func:`mesh_block` each, the
    encoder output ``enc`` read by every decoder layer but the hybrid's
    shared block). Returns (x, the unit's auxiliary losses: a list of
    values by name)."""
    auxs: Dict[str, list] = {}
    for blk, lp in zip(blocks, lps):
        x, aux = mesh_block(lp, cfg, x, pos_ids, mesh, causal=blk.causal,
                            enc=None if blk.layer == "shared" else enc, backend=backend)
        for name, v in aux.items():
            auxs.setdefault(name, []).append(v)
    return x, auxs


def _arange_positions(x: torch.Tensor) -> torch.Tensor:
    b, s = x.shape[:2]
    return torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)


def mesh_embed(w: Dict[Any, Any], params, cfg: ModelConfig, tokens, mesh, dtype, *,
               patch_embeds=None, positions=None) -> Dict[Any, torch.Tensor]:
    """Each position of ``w`` (its weights, :func:`_position_weights`)
    looks its batch shard of ``tokens`` (a placed leaf) up in its slice of
    the table's ``d_model`` columns; where ``model`` splits them (the
    placed ``params``' spec says), the slices are all-gathered over
    ``model``. Then, as :func:`_prepare_inputs`: a VLM prepends its batch
    shard of the placed ``patch_embeds``, and an encdec model adds the
    sinusoid of ``positions`` (a placed leaf; ``arange`` over every
    position where None). Returns ``{position: (B_l, S, d_model)}``
    (a VLM's S counts its patches)."""
    from repro_torch.sharding.placed import all_gather

    x = {pos: embed_tokens(wp, cfg, tokens.local(pos), dtype) for pos, wp in w.items()}
    if _model_split(params["embed"]["embedding"], 1) and mesh.shape.get("model", 1) > 1:
        x = all_gather(x, mesh, "model", -1)
    if cfg.family == "vlm" and cfg.frontend == "vision_stub":
        x = {pos: torch.cat([patch_embeds.local(pos).to(dtype), t], dim=1) for pos, t in x.items()}
    if cfg.family == "encdec":
        x = {pos: t + _sinusoid(_arange_positions(t) if positions is None
                                else positions.local(pos), cfg.d_model).to(dtype)
             for pos, t in x.items()}
    return x


def mesh_encode(w: Dict[Any, Any], cfg: ModelConfig, enc_embeds, mesh, dtype, *,
                backend: str = "auto") -> Dict[Any, torch.Tensor]:
    """An encdec model's encoder on a mesh, as :func:`_encode`: each
    position's batch shard of the placed ``enc_embeds`` plus the sinusoid,
    the encoder's blocks non-causal (:func:`mesh_block`, K4 on each
    position's heads on the card), then the encoder's ``final_norm``.
    Returns each position's encoder output, which every decoder layer's
    cross-attention reads."""
    x = {pos: enc_embeds.local(pos).to(dtype) for pos in w}
    pos_ids = {pos: _arange_positions(t) for pos, t in x.items()}
    x = {pos: t + _sinusoid(pos_ids[pos], cfg.d_model).to(dtype) for pos, t in x.items()}
    layers = {pos: _layers(wp["encoder"]["layers"], cfg.encoder_layers) for pos, wp in w.items()}
    for blocks in remat_units(cfg, "enc"):
        x, _ = remat.unit(functools.partial(_mesh_unit, blocks, cfg, mesh, backend), cfg, x,
                          [{pos: layers[pos][blk.layer] for pos in w} for blk in blocks],
                          pos_ids, None)
    return {pos: apply_norm(wp["encoder"]["final_norm"], cfg, x[pos]) for pos, wp in w.items()}


def mesh_unembed(w: Dict[Any, Any], params, cfg: ModelConfig, x: Dict[Any, torch.Tensor],
                 mesh) -> Dict[Any, torch.Tensor]:
    """The final norm and the logits of each batch shard's hidden state
    ``x`` (a copy at each position of ``w``). Where ``model`` splits the
    ``lm_head``'s vocab (the placed ``params``' spec says), every position
    computes its slice and the slices are gathered onto the batch shard's
    ``model`` index 0; else that position alone computes them whole.
    Returns ``{that position: (B_l, S, vocab) logits}`` in position order."""
    from repro_torch.sharding.placed import axis_groups

    names = mesh.axis_names
    mi = names.index("model") if "model" in names else None
    active = list(w)
    vocab_split = _model_split(params["embed"]["lm_head"], 1) and mesh.shape.get("model", 1) > 1
    heads = [p for p in active if mi is None or p[mi] == 0]
    logits = {pos: unembed(w[pos], cfg, apply_norm(w[pos]["final_norm"], cfg, x[pos]))
              for pos in (active if vocab_split else heads)}
    if not vocab_split:
        return logits
    out = {}
    for members in axis_groups(mesh, "model", active):
        dev = mesh.device(members[0])
        out[members[0]] = torch.cat([logits[p].to(dev) for p in members], dim=-1)
    return out


def _active_positions(mesh, tokens) -> list:
    """The positions whose batch shard of the placed ``tokens`` is distinct:
    index 0 along every non-``model`` axis the batch is not split over."""
    names, split = mesh.axis_names, set(tokens.spec.used())
    return [p for p in mesh.positions()
            if all(p[i] == 0 for i, a in enumerate(names) if a != "model" and a not in split)]


def mesh_forward(params, cfg: ModelConfig, batch: Dict, mesh, *,
                 backend: str = "auto") -> Tuple[Dict[Any, torch.Tensor], Dict[str, torch.Tensor]]:
    """The forward on a mesh, for the loss, of every family (dense with
    GQA or MLA, moe, ssm, hybrid, encdec, vlm): ``params`` and ``batch``
    hold :class:`~repro_torch.sharding.placed.Placed` leaves (the train
    rules' specs; the batch split over ``(pod, data)``).

    Every position whose batch shard is distinct (:func:`_active_positions`)
    runs its shard: the FSDP-gathered, cast weights
    (:func:`_position_weights`, the hybrid's ``shared`` block once), the
    embedding (:func:`mesh_embed`: a VLM's patches prepended, an encdec
    model's sinusoid added), an encdec model's encoder
    (:func:`mesh_encode`), every layer's :func:`mesh_block`
    (tensor-parallel attention with K4 on the position's own heads, the
    encdec decoder's cross-attention, the MLP, expert-parallel MoE,
    Mamba-1 on the position's own channels with K5, Mamba-2 on its own
    heads; the hybrid's shared block after every ``attn_every`` Mamba-2
    layers, in :func:`block_plan`'s order, so autograd sums its
    gradient over its applications; a weight whose heads, ``mlp`` dim,
    experts or channels do not split over ``model`` is computed whole at
    every ``model`` position, with no all-reduce), and the vocab-parallel
    logits (:func:`mesh_unembed`). Returns ({position: (B_l, S, vocab)
    logits} in position order, a moe model's ``moe_aux`` and ``moe_z``
    summed over its layers on the mesh's lead device, ``{}`` for the
    others). Autograd runs through the collectives, so the gradient of
    each stored shard is the reduce-scatter of its gathered copies'
    gradients."""
    check_family(cfg)
    dtype = torch_dtype(cfg.dtype)
    tokens = batch["tokens"]
    active = _active_positions(mesh, tokens)
    w = _position_weights(params, mesh, dtype, active)
    positions = batch.get("positions")
    x = mesh_embed(w, params, cfg, tokens, mesh, dtype, patch_embeds=batch.get("patch_embeds"),
                   positions=positions)
    pos_ids = {pos: _arange_positions(x[pos]) if positions is None else positions.local(pos)
               for pos in active}
    enc = (mesh_encode(w, cfg, batch["enc_embeds"], mesh, dtype, backend=backend)
           if cfg.family == "encdec" else None)
    layers = {pos: _layers(w[pos]["layers"], cfg.num_layers) for pos in active}
    auxs: Dict[str, list] = {}
    for blocks in remat_units(cfg, "dec"):
        lps = [{pos: w[pos]["shared"] if blk.layer == "shared" else layers[pos][blk.layer]
                for pos in active} for blk in blocks]
        x, aux = remat.unit(functools.partial(_mesh_unit, blocks, cfg, mesh, backend), cfg, x,
                            lps, pos_ids, enc)
        for name, vs in aux.items():
            auxs.setdefault(name, []).extend(vs)
    # as _scan_decoder: each loss summed over the stacked per-layer values
    return (mesh_unembed(w, params, cfg, x, mesh),
            {name: torch.stack(vs).sum() for name, vs in auxs.items()})
