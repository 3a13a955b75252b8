"""Mixture-of-Experts FFN: grouped top-k routing with capacity (GShard-style).

The port of ``repro.models.moe``, step for step, so that the dispatch is
the reference's own, drops included: tokens are routed in groups of
``moe_group_size``; each expert takes at most ``_capacity`` of a group's
(token, slot) pairs, in token order, and drops the rest; a sort-based
dispatch gathers the kept tokens, every expert runs at its full capacity,
and a gather-based combine adds the k slots back in slot order.

Where the two libraries differ, the port pins the reference's choice:
``jax.lax.top_k`` puts the lower index first on ties, so the top k are
the first k of a stable descending sort; dropped pairs write to a trash
column ``cap`` that is sliced off, as ``.at[...].set(mode="drop")`` does.
The expert products are plain large products, which the reference leaves
to XLA outside any Pallas kernel: here they are batched ``torch.bmm``
over the expert axis, on the weights as stored (no copy).

:func:`record_routing` lets a caller see each call's router logits and
chosen experts (``chip_smoke.py`` compares the two attention lanes'
routing with it).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Spec

__all__ = ["moe_params", "apply_moe", "route", "dispatch", "record_routing"]

_LOGS: List[list] = []


def moe_params(cfg: ModelConfig) -> Dict[str, Spec]:
    e, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff
    return {
        "router": Spec((d, e), ("embed", None)),
        "w_gate": Spec((e, d, ff), ("experts", "embed", "mlp")),
        "w_up": Spec((e, d, ff), ("experts", "embed", "mlp")),
        "w_down": Spec((e, ff, d), ("experts", "mlp", "embed")),
    }


def _capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    c = math.ceil(
        tokens_per_group * cfg.num_experts_per_tok * cfg.moe_capacity_factor / cfg.num_experts
    )
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


@contextlib.contextmanager
def record_routing() -> Iterator[list]:
    """Within the block, every :func:`apply_moe` call appends
    ``(logits, idx)`` to the yielded list: its f32 router logits (T, E) and
    its chosen experts (T, k), tokens in (group, position) order."""
    log: list = []
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


def route(params: Dict, cfg: ModelConfig, xg: torch.Tensor):
    """Router of a (G, gs, d) group batch: f32 logits and probabilities
    (G, gs, E), the top-k gates renormalized to sum 1 and their experts
    (G, gs, k), the lower expert first on ties."""
    k = cfg.num_experts_per_tok
    logits = (xg @ params["router"].to(xg.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top[..., :k], order[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gates, idx


class Dispatch(NamedTuple):
    ids: torch.Tensor          # (G, E, cap) token of each expert slot (0 where empty)
    valid: torch.Tensor        # (G, E, cap) 1 where the slot holds a token
    gate_ec: torch.Tensor      # (G, E, cap) that token's gate
    counts: torch.Tensor       # (G, E) (token, slot) pairs routed to each expert
    pos: torch.Tensor          # (G, gs, k) each pair's rank in its expert's queue
    within: torch.Tensor       # (G, gs, k) pos < cap: the pair was kept


def dispatch(idx: torch.Tensor, gates: torch.Tensor, cap: int, num_experts: int,
             dtype) -> Dispatch:
    """The reference's sort-based capacity bookkeeping: pairs grouped by
    expert (stable, so in token order), each pair's rank in its expert's
    queue, the first ``cap`` of each queue kept and the rest dropped."""
    g, gs, k = idx.shape
    dev = idx.device
    flat_e = idx.reshape(g, gs * k)
    order = torch.argsort(flat_e, dim=1, stable=True)          # slots grouped by expert
    sorted_e = torch.gather(flat_e, 1, order)
    counts = torch.zeros((g, num_experts), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))     # tokens per expert
    starts = torch.cumsum(counts, dim=1) - counts               # exclusive prefix
    pos_sorted = (torch.arange(gs * k, device=dev)[None]
                  - torch.gather(starts, 1, sorted_e))          # position in expert queue
    within = pos_sorted < cap                                   # drop policy == token order
    tok_sorted = order // k
    gate_sorted = torch.gather(gates.reshape(g, gs * k), 1, order)

    c_ix = torch.where(within, pos_sorted, cap)                 # overflow -> trash slot
    g_row = torch.arange(g, device=dev)[:, None].expand_as(sorted_e)
    ids = torch.zeros((g, num_experts, cap + 1), dtype=torch.int64, device=dev)
    ids[g_row, sorted_e, c_ix] = tok_sorted
    valid = torch.zeros((g, num_experts, cap + 1), dtype=dtype, device=dev)
    valid[g_row, sorted_e, c_ix] = 1.0
    gate_ec = torch.zeros((g, num_experts, cap + 1), dtype=dtype, device=dev)
    gate_ec[g_row, sorted_e, c_ix] = gate_sorted.to(dtype)

    pos_orig = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted).reshape(g, gs, k)
    return Dispatch(ids[..., :cap], valid[..., :cap], gate_ec[..., :cap], counts, pos_orig,
                    pos_orig < cap)


def apply_moe(params: Dict, cfg: ModelConfig, x: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, d) -> (out, aux_losses). The B*S tokens are routed in
    groups of ``min(moe_group_size, B*S)``, which must divide B*S."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    dtype = x.dtype
    t = b * s
    gs = min(cfg.moe_group_size, t)
    if t % gs:
        raise ValueError(f"MoE routing groups of {gs} tokens must divide the {t} tokens "
                         f"(B={b}, S={s})")
    g = t // gs
    xg = x.reshape(g, gs, d)

    # --- routing ---
    logits, probs, gates, idx = route(params, cfg, xg)
    for log in _LOGS:
        log.append((logits.reshape(t, e), idx.reshape(t, k)))

    # --- capacity bookkeeping: sort-based ---
    cap = _capacity(gs, cfg)
    dp = dispatch(idx, gates, cap, e, dtype)

    # --- expert compute: every expert at its full capacity ---
    xe = torch.gather(xg, 1, dp.ids.reshape(g, e * cap, 1).expand(g, e * cap, d))
    xe = xe.reshape(g, e, cap, d) * dp.valid[..., None]
    xe = xe.transpose(0, 1).reshape(e, g * cap, d)             # "gecd" as E batches
    up = torch.bmm(xe, params["w_up"].to(dtype))
    gate = torch.bmm(xe, params["w_gate"].to(dtype))
    h = F.silu(gate) * up
    y = torch.bmm(h, params["w_down"].to(dtype)).reshape(e, g, cap, d).transpose(0, 1)
    y = y * (dp.gate_ec * dp.valid)[..., None]

    # --- combine: k gathers in token order, added in slot order ---
    slot_flat = idx * cap + torch.where(dp.within, dp.pos, 0)  # (g, gs, k)
    y_flat = y.reshape(g, e * cap, d)
    out = torch.zeros((g, gs, d), dtype=dtype, device=x.device)
    for kk in range(k):
        got = torch.gather(y_flat, 1, slot_flat[..., kk, None].expand(g, gs, d))
        out = out + torch.where(dp.within[..., kk, None], got, 0.0)

    # --- aux losses (load balance + router z-loss) ---
    density = dp.counts.float() / (gs * k)                     # (g, e) token frac
    p_mean = probs.mean(dim=1)                                 # (g, e)
    aux = e * torch.mean(torch.sum(density * p_mean, dim=-1)) * k
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    losses = {
        "moe_aux": cfg.router_aux_coef * aux,
        "moe_z": cfg.router_z_coef * z,
    }
    return out.reshape(b, s, d), losses
