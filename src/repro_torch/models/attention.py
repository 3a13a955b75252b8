"""Attention: GQA (dense and memory-chunked) and MLA (latent, absorbed
decode), with kernel K4 on the prefill.

The port of ``repro.models.attention``. Shapes: activations (B, S, d_model);
q/k/v (B, S, heads, head_dim) with GQA grouping H = KV * G. Decode uses a
cache, which :func:`update_cache` writes in place (the reference's is
functional): a served model keeps one cache and never needs the old one.
  * GQA: ``{"k": (B, L, KV, D), "v": (B, L, KV, D)}``;
  * MLA (``minicpm3-4b``): ``{"ckv": (B, L, kv_lora_rank), "k_rope": (B, L,
    qk_rope_head_dim)}``, the latent cache; the decode step uses the
    *absorbed* form (q projected into the latent space), so the cache is
    never expanded to per-head keys and values.

On one device the reference's tensor-parallel head layouts reduce to its
single-device branch (KV heads kept, G query heads per KV head; MLA and
cross-attention have KV = H, G = 1). On a mesh (:func:`attention_mesh`)
each ``model`` position runs :func:`apply_attention` on its own query
heads and the KV heads they read (MLA: its heads, from the query latent
gathered over ``model``), with a config of those head counts, and its
partial ``wo`` product is summed over the positions. Cross-attention
(``whisper``'s decoder) reads the encoder's keys and values, projected once
by :func:`cross_kv`, with no mask and no positions; on a mesh
(:func:`cross_attention_mesh`) each position projects its own heads'.

Lanes (``backend``, as the edge path's): on a CUDA tensor the prefill and
forward attention (S query positions over the same S keys) run K4,
``kernels/csrc/flash_attention.cu``, at every length; the decode read path
(S == 1 over the whole slotted cache) is plain PyTorch, as the reference
leaves it to XLA. MLA's expanded prefill has q and k of
``qk_nope_head_dim + qk_rope_head_dim`` dims but v of ``v_head_dim``: K4
takes v of k's width, so v is zero-padded to it and the output sliced
back, which is exact (zero columns add nothing, and the softmax does not
read v); K4's scale, 1/sqrt of q's width, is the reference's. The
prefill's cross-attention (S decoder positions over the encoder's T
frames) runs K4 non-causal on the card; a single query row (the decode
step's cross read) is plain PyTorch on both lanes. K4 masks by
index, so on the card the causal prefill raises unless ``positions`` is
``arange(S)`` in every row, which is what ``transformer._prepare_inputs``
and the engine give; it also raises for an ``attn_logit_softcap`` (K4 has
none, and no ported config sets one). The plain lane (``backend="torch"``,
and every CPU tensor) runs :func:`dot_attention` and follows the
reference's switch to the chunked online softmax above 4,096 positions.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dispatch import resolve_backend, resolve_device
from repro_torch.kernels.flash_attention import k4_attention
from repro_torch.models.layers import Spec, apply_rope

__all__ = [
    "attention_params",
    "apply_attention",
    "cross_attention_params",
    "apply_cross_attention",
    "cross_kv",
    "init_attn_cache",
    "dot_attention",
    "update_cache",
    "attention_mesh",
    "cross_attention_mesh",
]

_NEG_INF = -1e30


def update_cache(cache_arr: torch.Tensor, new: torch.Tensor, index) -> torch.Tensor:
    """Write ``new`` (B, S, ...) into the length axis (1) of ``cache_arr`` in
    place; returns ``cache_arr``.

    index shapes, as the reference's: scalar -> contiguous at
    [index, index+S) (prefill; a negative start counts from the end, and
    the start is clamped so the block fits), a single token only where
    0 <= index < L; (B,) -> one slot per sequence (continuous-batching
    decode); (B, S) -> arbitrary per-token destinations (padded prefill; pad
    tokens aimed at a trash slot). Vector indices count negatives from the
    end and drop what still falls outside [0, L). Duplicate destinations
    (pad tokens sharing the trash slot) leave one of their values, unspecified
    which.
    """
    new = new.to(cache_arr.dtype)
    length = cache_arr.shape[1]
    index = torch.as_tensor(index)
    if index.ndim == 0:
        i, s = int(index), new.shape[1]
        if s == 1:
            if 0 <= i < length:
                cache_arr[:, i] = new[:, 0]
            return cache_arr
        i = i + length if i < 0 else i
        start = min(max(i, 0), length - s)
        cache_arr[:, start:start + s] = new
        return cache_arr
    index = index.to(device=cache_arr.device, dtype=torch.long)
    index = torch.where(index < 0, index + length, index)
    keep = (index >= 0) & (index < length)
    b = cache_arr.shape[0]
    rows = torch.arange(b, device=cache_arr.device)
    if index.ndim == 1:
        # A dropped slot writes its old value back (no host sync for the mask).
        idx = index.clamp(0, length - 1)
        sel = keep.reshape((b,) + (1,) * (new.ndim - 2))
        cache_arr[rows, idx] = torch.where(sel, new[:, 0], cache_arr[rows, idx])
        return cache_arr
    rows = rows[:, None].expand_as(index)
    cache_arr[rows[keep], index[keep]] = new[keep]
    return cache_arr


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def attention_params(cfg: ModelConfig) -> Dict[str, Spec]:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cfg.attn_type == "mla":
        nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        v = cfg.v_head_dim
        p: Dict[str, Spec] = {
            "wkv_a": Spec((d, cfg.kv_lora_rank + rope), ("embed", None)),
            "kv_norm": Spec((cfg.kv_lora_rank,), (None,), "ones"),
            "wk_b": Spec((cfg.kv_lora_rank, h, nope), (None, "heads", None)),
            "wv_b": Spec((cfg.kv_lora_rank, h, v), (None, "heads", None)),
            "wo": Spec((h, v, d), ("heads", None, "embed")),
        }
        if cfg.q_lora_rank:
            p["wq_a"] = Spec((d, cfg.q_lora_rank), ("embed", "qk_rank"))
            p["q_norm"] = Spec((cfg.q_lora_rank,), (None,), "ones")
            p["wq_b"] = Spec((cfg.q_lora_rank, h, nope + rope), (None, "heads", None))
        else:
            p["wq"] = Spec((d, h, nope + rope), ("embed", "heads", None))
        return p

    p = {
        "wq": Spec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": Spec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": Spec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": Spec((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        p["q_norm"] = Spec((hd,), (None,), "ones")
        p["k_norm"] = Spec((hd,), (None,), "ones")
    return p


def cross_attention_params(cfg: ModelConfig) -> Dict[str, Spec]:
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    return {
        "wq": Spec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": Spec((d, h, hd), ("embed", "heads", "head_dim")),
        "wv": Spec((d, h, hd), ("embed", "heads", "head_dim")),
        "wo": Spec((h, hd, d), ("heads", "head_dim", "embed")),
    }


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------

def _rms(x, scale, eps):
    y = x.float()
    y = y * torch.rsqrt((y * y).mean(dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def _mask_block(pos_q, pos_k, causal: bool):
    if not causal:
        return None
    return pos_q[:, :, None] >= pos_k[:, None, :]          # (B, S, C)


def dot_attention(
    q: torch.Tensor,              # (B, S, KV, G, D)
    k: torch.Tensor,              # (B, T, KV, D)
    v: torch.Tensor,              # (B, T, KV, Dv)
    *,
    pos_q: Optional[torch.Tensor] = None,    # (B, S)
    pos_k: Optional[torch.Tensor] = None,    # (B, T)
    causal: bool = True,
    impl: str = "dense",
    chunk: int = 1024,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Grouped-query attention core, plain PyTorch. Returns (B, S, KV, G, Dv).

    The mask is derived from positions (``pos_q >= pos_k`` when causal);
    the chunked path builds it per KV chunk inside the online softmax.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    q = (q * scale).to(q.dtype)
    b, s_len = q.shape[0], q.shape[1]
    t = k.shape[1]
    if causal and (pos_q is None or pos_k is None):
        raise ValueError("causal attention needs pos_q and pos_k")

    if impl == "dense" or t <= chunk:
        s = torch.einsum("bskgd,btkd->bkgst", q, k).float()
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        mask = _mask_block(pos_q, pos_k, causal)
        if mask is not None:
            s = torch.where(mask[:, None, None], s, _NEG_INF)
        w = torch.softmax(s, dim=-1).to(q.dtype)
        return torch.einsum("bkgst,btkd->bskgd", w, v)

    # Chunked online softmax: a loop over KV chunks with running
    # (max, denom, acc), so the (S x T) score matrix is never materialized.
    if t % chunk:
        raise ValueError(f"chunked attention needs T % chunk == 0, got T={t}, chunk={chunk}")
    if pos_k is None:
        pos_k = torch.arange(t, dtype=torch.int32, device=k.device)[None].expand(b, t)
    kv_h, g = q.shape[2], q.shape[3]
    m_run = torch.full((b, kv_h, g, s_len), _NEG_INF, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((b, kv_h, g, s_len), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kv_h, g, s_len, v.shape[-1]), dtype=torch.float32, device=q.device)
    for c0 in range(0, t, chunk):
        k_j, v_j, pk_j = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk], pos_k[:, c0:c0 + chunk]
        s = torch.einsum("bskgd,btkd->bkgst", q, k_j).float()
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        mask_j = _mask_block(pos_q, pk_j, causal)
        if mask_j is not None:
            s = torch.where(mask_j[:, None, None], s, _NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p.to(q.dtype), v_j).float()
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)  # (B,S,KV,G,Dv)


def _k4_attention(q5: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool) -> torch.Tensor:
    """``dot_attention`` over ``pos_q = pos_k = arange(S)`` through K4: fold
    (KV, G) into H, repeat each KV head for its G query heads, and call the
    kernel with ``block_q = S`` and ``block_kv = T``, which its shape rule
    accepts at any length. The call is :func:`k4_attention`, so the card
    lane trains: K4 forward, the plain version recomputed for the
    backward. Returns (B, S, KV, G, D)."""
    b, s, kv, g, d = q5.shape
    qh = q5.permute(0, 2, 3, 1, 4).reshape(b, kv * g, s, d)
    kh = k.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    vh = v.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    out = k4_attention(qh, kh, vh, causal=causal, block_q=s, block_kv=kh.shape[2])
    return out.reshape(b, kv, g, s, d).permute(0, 3, 1, 2, 4)


def _k4_attention_narrow_v(q5: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           causal: bool) -> torch.Tensor:
    """:func:`_k4_attention` for v narrower than k (MLA): v zero-padded to
    k's width, the output sliced back. Returns (B, S, KV, G, Dv)."""
    dv = v.shape[-1]
    out = _k4_attention(q5, k, F.pad(v, (0, k.shape[-1] - dv)), causal)
    return out[..., :dv]


def _check_k4_call(cfg: ModelConfig, positions: torch.Tensor, causal: bool) -> None:
    """What K4 cannot take on the card raises; nothing falls back."""
    if cfg.attn_logit_softcap:
        raise ValueError(f"attn_logit_softcap={cfg.attn_logit_softcap}: kernel K4 has no "
                         "softcap; run backend='torch' for such a config")
    if causal:
        b, s = positions.shape
        index = torch.arange(s, device=positions.device, dtype=positions.dtype)
        if not torch.equal(positions, index.expand(b, s)):
            raise ValueError("kernel K4 masks by index: the causal prefill on the card needs "
                             "positions = arange(S) in every row; run backend='torch' for "
                             "other positions")


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def _gqa_qkv(params, cfg: ModelConfig, x, positions):
    dtype = x.dtype
    b, s, d = x.shape

    def proj(w):   # "bsd,dhk->bshk"
        return (x @ w.to(dtype).reshape(d, -1)).reshape(b, s, w.shape[1], w.shape[2])

    q, k, v = proj(params["wq"]), proj(params["wk"]), proj(params["wv"])
    if cfg.qk_norm:
        q = _rms(q, params["q_norm"], cfg.norm_eps)
        k = _rms(k, params["k_norm"], cfg.norm_eps)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _head_layout(cfg: ModelConfig, q):
    """The reference's single-device layout: (B, S, H, D) -> (B, S, KV, G, D)."""
    b, s = q.shape[0], q.shape[1]
    kv_h = cfg.num_kv_heads
    return q.reshape(b, s, kv_h, cfg.num_heads // kv_h, q.shape[-1])


def _gqa_out(params, out):
    # out: (B, S, KV, G, D) -> (B, S, H * D) -> (B, S, d_model)
    b, s, kv, g, d = out.shape
    wo = params["wo"].to(out.dtype)
    return out.reshape(b, s, kv * g * d) @ wo.reshape(kv * g * d, -1)


def apply_attention(
    params: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    causal: bool = True,
    cache: Optional[Dict] = None,
    cache_index=None,
    attn_chunk: int = 1024,
    backend: str = "auto",
    q_latent: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Self-attention (GQA or MLA).

    With ``cache``: S == 1 is a decode step reading the cache; S > 1 is a
    prefill, which attends over the freshly computed local k/v (never the
    padded cache) while the cache is written through (in place).
    ``backend``: ``auto`` (K4 for a CUDA tensor, plain for the CPU),
    ``cuda`` or ``torch``. ``q_latent``: MLA's ``x @ wq_a`` computed
    already (on a mesh, the position's slices all-gathered), in place of
    the product with ``params["wq_a"]``.
    """
    lane = resolve_backend(backend, x.device)
    if cfg.attn_type == "mla":
        return _apply_mla(params, cfg, x, positions, causal=causal, cache=cache,
                          cache_index=cache_index, lane=lane, q_latent=q_latent)
    kv_h, g = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    q, k, v = _gqa_qkv(params, cfg, x, positions)
    b, s = x.shape[0], x.shape[1]

    new_cache = None
    if cache is not None:
        new_cache = {
            "k": update_cache(cache["k"], k, cache_index),
            "v": update_cache(cache["v"], v, cache_index),
        }

    if cache is not None and s == 1:
        # decode read path (plain PyTorch on both lanes)
        k_full, v_full = new_cache["k"], new_cache["v"]
        t = k_full.shape[1]
        q5 = q.reshape(b, 1, kv_h, g, cfg.head_dim)
        pos_k = torch.arange(t, dtype=torch.int32, device=x.device)[None].expand(b, t)
        out = dot_attention(q5, k_full, v_full, pos_q=positions, pos_k=pos_k, causal=True,
                            impl="dense")
        return _gqa_out(params, out), new_cache

    q5 = _head_layout(cfg, q)
    if lane == "cuda":
        _check_k4_call(cfg, positions, causal)
        out = _k4_attention(q5, k, v, causal)
    else:
        impl = "chunked" if s > 4096 else "dense"
        out = dot_attention(
            q5, k, v,
            pos_q=positions, pos_k=positions, causal=causal,
            impl=impl, chunk=attn_chunk, softcap=cfg.attn_logit_softcap,
        )
    return _gqa_out(params, out), new_cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 / MiniCPM3-style multi-head latent attention)
# ---------------------------------------------------------------------------

def _mla_q(params, cfg: ModelConfig, x, positions, cq=None):
    dtype = x.dtype
    b, s, d = x.shape
    nope = cfg.qk_nope_head_dim
    if cfg.q_lora_rank:
        cq = x @ params["wq_a"].to(dtype) if cq is None else cq
        cq = _rms(cq, params["q_norm"], cfg.norm_eps)
        w = params["wq_b"].to(dtype)                       # "bsr,rhk->bshk"
    else:
        cq, w = x, params["wq"].to(dtype)                  # "bsd,dhk->bshk"
    q = (cq @ w.reshape(w.shape[0], -1)).reshape(b, s, w.shape[1], w.shape[2])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_latent(params, cfg: ModelConfig, x, positions):
    rank = cfg.kv_lora_rank
    kv = x @ params["wkv_a"].to(x.dtype)
    ckv, k_rope = kv[..., :rank], kv[..., rank:]
    ckv = _rms(ckv, params["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)  # shared rope head
    return ckv, k_rope


def _apply_mla(params, cfg: ModelConfig, x, positions, *, causal, cache, cache_index, lane,
               q_latent=None):
    b, s = x.shape[0], x.shape[1]
    h = cfg.num_heads
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    rank = cfg.kv_lora_rank
    scale = 1.0 / math.sqrt(nope + rope)
    q_nope, q_rope = _mla_q(params, cfg, x, positions, q_latent)
    ckv_new, k_rope_new = _mla_latent(params, cfg, x, positions)
    dtype = x.dtype
    wk_b, wv_b = params["wk_b"].to(dtype), params["wv_b"].to(dtype)
    wo = params["wo"].to(dtype)

    new_cache = None
    if cache is not None:
        new_cache = {
            "ckv": update_cache(cache["ckv"], ckv_new, cache_index),
            "k_rope": update_cache(cache["k_rope"], k_rope_new, cache_index),
        }

    if cache is not None and s == 1:
        # Absorbed decode (plain PyTorch on both lanes): q_nope -> latent
        # space; the cache stays compressed.
        ckv, kr = new_cache["ckv"], new_cache["k_rope"]
        t = ckv.shape[1]
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope, wk_b)
        s_lat = torch.einsum("bshr,blr->bhsl", q_lat, ckv)
        s_rope = torch.einsum("bshp,blp->bhsl", q_rope, kr)
        logits = (s_lat + s_rope).float() * scale
        valid = torch.arange(t, device=x.device)[None, None, :] <= positions[:, :, None]
        logits = torch.where(valid[:, None], logits, _NEG_INF)
        w = torch.softmax(logits, dim=-1).to(dtype)
        ctx_lat = torch.einsum("bhsl,blr->bshr", w, ckv)
        out_v = torch.einsum("bshr,rhv->bshv", ctx_lat, wv_b)
        return out_v.reshape(b, s, h * vd) @ wo.reshape(h * vd, -1), new_cache

    # Prefill / forward: expand the latent to per-head k and v (standard form).
    k_nope = (ckv_new @ wk_b.reshape(rank, h * nope)).reshape(b, s, h, nope)
    v = (ckv_new @ wv_b.reshape(rank, h * vd)).reshape(b, s, h, vd)
    k_rope_b = k_rope_new[:, :, None, :].expand(b, s, h, rope)
    k = torch.cat([k_nope, k_rope_b], dim=-1)
    q5 = torch.cat([q_nope, q_rope], dim=-1)[:, :, :, None, :]   # KV = H, G = 1
    if lane == "cuda":
        _check_k4_call(cfg, positions, causal)
        out = _k4_attention_narrow_v(q5, k, v, causal)
    else:
        impl = "chunked" if s > 4096 else "dense"
        out = dot_attention(q5, k, v, pos_q=positions, pos_k=positions, causal=causal,
                            impl=impl)
    return out.reshape(b, s, h * vd) @ wo.reshape(h * vd, -1), new_cache


# ---------------------------------------------------------------------------
# On a mesh (training): each ``model`` position's own heads
# ---------------------------------------------------------------------------

def _gqa_shard(attn: Dict, cfg: ModelConfig, h_l: int, q0: int) -> Tuple[Dict, ModelConfig]:
    """A position's GQA weights and head counts: its ``h_l`` query heads
    from ``q0`` and the KV heads they read (query head ``h`` reads KV head
    ``h // G``, as on one device). Whole KV heads are cut to those: a
    contiguous run where the local heads group evenly, else one KV head
    per query head."""
    g = cfg.num_heads // cfg.num_kv_heads
    if attn["wk"].shape[1] == cfg.num_kv_heads:
        idx = [(q0 + j) // g for j in range(h_l)]
        kv0, kv_l = idx[0], idx[-1] + 1 - idx[0]
        if h_l % kv_l == 0 and idx == [kv0 + j // (h_l // kv_l) for j in range(h_l)]:
            wk, wv = attn["wk"][:, kv0:kv0 + kv_l], attn["wv"][:, kv0:kv0 + kv_l]
        else:                                         # a KV head split across positions
            sel = torch.tensor(idx, device=attn["wk"].device)
            wk, wv = attn["wk"].index_select(1, sel), attn["wv"].index_select(1, sel)
        attn = dict(attn, wk=wk, wv=wv)
    return attn, cfg.replace(num_heads=h_l, num_kv_heads=attn["wk"].shape[1])


def attention_mesh(attns: Dict[Any, Dict], cfg: ModelConfig, x: Dict[Any, torch.Tensor],
                   pos_ids: Dict[Any, torch.Tensor], mesh, *, causal: bool = True,
                   backend: str = "auto") -> Dict[Any, torch.Tensor]:
    """Tensor-parallel self-attention on a mesh. ``attns`` holds each
    position's attention weights (its own heads' where ``model`` splits
    them, the rest whole), ``x`` each position's normed input. Each
    position runs :func:`apply_attention` with its local head counts (K4
    once a position on the card, non-causal for an encoder's
    ``causal=False``); split heads mean a row-parallel ``wo``,
    whose partial products are summed over ``model`` (an all-reduce).

    GQA: whole KV heads are cut to the ones the position's query heads
    read (:func:`_gqa_shard`). MLA: ``wq_a``'s ``qk_rank`` columns split
    over ``model`` give each position a slice of the query latent, which
    is all-gathered before ``q_norm`` (an RMS over all of it); ``wkv_a``
    is whole, so each position forms the whole key latent and expands it
    with its heads' ``wk_b`` and ``wv_b``. Returns each position's
    attention output, summed over ``model`` where the heads split."""
    from repro_torch.sharding.placed import all_gather, all_reduce

    mi = mesh.axis_names.index("model") if "model" in mesh.axis_names else None
    mla = cfg.attn_type == "mla"
    q_latent = {}
    if mla and cfg.q_lora_rank:
        q_latent = {pos: x[pos] @ a["wq_a"].to(x[pos].dtype) for pos, a in attns.items()}
        if next(iter(attns.values()))["wq_a"].shape[1] < cfg.q_lora_rank:
            q_latent = all_gather(q_latent, mesh, "model", -1)
    part, heads_split = {}, False
    for pos, attn in attns.items():
        h_l = attn["wo"].shape[0]
        heads_split = h_l < cfg.num_heads
        q0 = pos[mi] * h_l if heads_split else 0
        if mla:
            local = cfg.replace(num_heads=h_l, num_kv_heads=h_l)
        else:
            attn, local = _gqa_shard(attn, cfg, h_l, q0)
        part[pos] = apply_attention(attn, local, x[pos], pos_ids[pos], causal=causal,
                                    backend=backend, q_latent=q_latent.get(pos))[0]
    return all_reduce(part, mesh, "model") if heads_split else part


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder); encoder k/v precomputed once.
# ---------------------------------------------------------------------------

def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """"bsd,dhk->bshk" as one product."""
    b, s, d = x.shape
    return (x @ w.to(x.dtype).reshape(d, -1)).reshape(b, s, w.shape[1], w.shape[2])


def apply_cross_attention(params, cfg: ModelConfig, x, enc_k, enc_v, *,
                          backend: str = "auto") -> torch.Tensor:
    """x (B, S, d_model) attends, unmasked, over the encoder's ``enc_k`` and
    ``enc_v`` (B, T, H, D): K4 non-causal on the card for S > 1 (``auto``
    on a CUDA tensor, or ``cuda``), plain PyTorch for one query row and
    on the plain lane. The reference applies no softcap here, so K4 takes
    every config."""
    b, s = x.shape[0], x.shape[1]
    q5 = _heads(x, params["wq"])[:, :, :, None, :]          # KV = H, G = 1
    if resolve_backend(backend, x.device) == "cuda" and s > 1:
        out = _k4_attention(q5, enc_k, enc_v, causal=False)
    else:
        out = dot_attention(q5, enc_k, enc_v, causal=False, impl="dense")
    h, hd = cfg.num_heads, cfg.head_dim
    return out.reshape(b, s, h * hd) @ params["wo"].to(x.dtype).reshape(h * hd, -1)


def cross_kv(params, cfg: ModelConfig, enc_out):
    """The encoder output's keys and values for one layer's cross-attention,
    each (B, T, H, D)."""
    return _heads(enc_out, params["wk"]), _heads(enc_out, params["wv"])


def cross_attention_mesh(crosses: Dict[Any, Dict], cfg: ModelConfig,
                         x: Dict[Any, torch.Tensor], enc: Dict[Any, torch.Tensor], mesh, *,
                         backend: str = "auto") -> Dict[Any, torch.Tensor]:
    """Tensor-parallel cross-attention on a mesh. ``crosses`` holds each
    position's cross-attention weights (``wq``, ``wk``, ``wv`` and ``wo``
    on its own heads where ``model`` splits them), ``x`` its normed
    decoder input and ``enc`` its copy of its batch shard's encoder
    output. Each position projects its own heads' keys and values
    (:func:`cross_kv`) and runs :func:`apply_cross_attention` at its local
    head count (K4 non-causal once a position on the card); split heads
    mean a row-parallel ``wo``, summed over ``model``. Returns each
    position's output."""
    from repro_torch.sharding.placed import all_reduce

    part, heads_split = {}, False
    for pos, cross in crosses.items():
        h_l = cross["wo"].shape[0]
        heads_split = h_l < cfg.num_heads
        local = cfg.replace(num_heads=h_l, num_kv_heads=h_l)
        part[pos] = apply_cross_attention(cross, local, x[pos], *cross_kv(cross, local, enc[pos]),
                                          backend=backend)
    return all_reduce(part, mesh, "model") if heads_split else part


# ---------------------------------------------------------------------------
# Cache init
# ---------------------------------------------------------------------------

def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                    device=None) -> Dict:
    """Zero caches on ``device`` (``None`` = the CUDA device): k/v (GQA) or
    the latent ``ckv`` and shared ``k_rope`` (MLA)."""
    dev = resolve_device(device)
    if cfg.attn_type == "mla":
        return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=dev),
                "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim), dtype=dtype,
                                      device=dev)}
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}
