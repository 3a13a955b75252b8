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

:func:`record_routing` lets a caller see each call's router logits,
chosen experts and kept slots (``chip_smoke.py`` compares the two
attention lanes' routing, and a mesh's with one device's, with it).

On a mesh (expert parallelism, :func:`moe_mesh`) each ``model``
position runs :func:`moe_groups` on the experts it holds: the routing and
the bookkeeping of every expert, its own experts' products, and the slots
routed to them; the positions' partial outputs are then summed over
``model``. The groups are the whole microbatch's (:func:`group_size`),
as the reference routes them, not a batch shard's.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Iterator, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Spec

__all__ = ["moe_params", "apply_moe", "moe_groups", "moe_mesh", "group_size", "aux_losses",
           "route", "dispatch", "record_routing"]

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
    ``(logits, idx, kept)`` to the yielded list: its f32 router logits (T,
    E), its chosen experts (T, k) and which of those (token, expert) pairs
    its experts' capacity kept (T, k), tokens in (group, position) order.
    On a mesh (``transformer.mesh_block``) each routing group is logged
    once, by the ``model`` position that routes it first, so the entries
    of one layer follow the whole microbatch's token order."""
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
    gs = group_size(cfg, b * s)
    out, per_group, lse2 = moe_groups(params, cfg, x.reshape(b * s // gs, gs, d))
    return out.reshape(b, s, d), aux_losses(cfg, per_group.mean(), lse2.mean())


def group_size(cfg: ModelConfig, tokens: int) -> int:
    """The routing groups' size for ``tokens`` tokens (a whole microbatch's,
    as the reference routes them): ``min(moe_group_size, tokens)``, which
    must divide them."""
    gs = min(cfg.moe_group_size, tokens)
    if tokens % gs:
        raise ValueError(f"MoE routing groups of {gs} tokens must divide the {tokens} tokens")
    return gs


def aux_losses(cfg: ModelConfig, balance: torch.Tensor, z: torch.Tensor) -> Dict:
    """The auxiliary losses from the mean over the groups of ``sum_e
    density * p_mean`` and the mean over the tokens of the router's
    squared log-normalizer."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    return {"moe_aux": cfg.router_aux_coef * (e * balance * k),
            "moe_z": cfg.router_z_coef * z}


def moe_groups(params: Dict, cfg: ModelConfig, xg: torch.Tensor, first_expert: int = 0,
               record: bool = True):
    """The MoE over routing groups ``xg`` (G, gs, d) with the experts
    ``params`` holds: all of them, or the ``E_l`` from ``first_expert``
    that a ``model`` position holds (expert parallelism). Every expert's
    routing and capacity bookkeeping is computed; only the held experts
    run, and the output adds only the slots routed to them (a position's
    partial sum). Appends the routing to every :func:`record_routing` log
    where ``record``. Returns (out (G, gs, d), each group's ``sum_e
    density * p_mean`` (G,), each token's squared log-normalizer (G, gs))."""
    g, gs, d = xg.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    dtype = xg.dtype

    # --- routing ---
    logits, probs, gates, idx = route(params, cfg, xg)

    # --- capacity bookkeeping: sort-based ---
    cap = _capacity(gs, cfg)
    dp = dispatch(idx, gates, cap, e, dtype)
    if record:
        for log in _LOGS:
            log.append((logits.reshape(g * gs, e), idx.reshape(g * gs, k),
                        dp.within.reshape(g * gs, k)))

    # --- expert compute: every held expert at its full capacity ---
    e_l = params["w_up"].shape[0]
    held = slice(first_expert, first_expert + e_l)
    ids, valid, gate_ec = dp.ids[:, held], dp.valid[:, held], dp.gate_ec[:, held]
    xe = torch.gather(xg, 1, ids.reshape(g, e_l * cap, 1).expand(g, e_l * cap, d))
    xe = xe.reshape(g, e_l, cap, d) * valid[..., None]
    xe = xe.transpose(0, 1).reshape(e_l, g * cap, d)           # "gecd" as E batches
    up = torch.bmm(xe, params["w_up"].to(dtype))
    gate = torch.bmm(xe, params["w_gate"].to(dtype))
    h = F.silu(gate) * up
    y = torch.bmm(h, params["w_down"].to(dtype)).reshape(e_l, g, cap, d).transpose(0, 1)
    y = y * (gate_ec * valid)[..., None]

    # --- combine: k gathers in token order, added in slot order ---
    mine = dp.within & (idx >= first_expert) & (idx < first_expert + e_l)
    slot_flat = (idx - first_expert).clamp(0, e_l - 1) * cap + torch.where(mine, dp.pos, 0)
    y_flat = y.reshape(g, e_l * cap, d)
    out = torch.zeros((g, gs, d), dtype=dtype, device=xg.device)
    for kk in range(k):
        got = torch.gather(y_flat, 1, slot_flat[..., kk, None].expand(g, gs, d))
        out = out + torch.where(mine[..., kk, None], got, 0.0)

    # --- aux terms (load balance + router z-loss), per group and per token ---
    density = dp.counts.float() / (gs * k)                     # (g, e) token frac
    p_mean = probs.mean(dim=1)                                 # (g, e)
    return out, torch.sum(density * p_mean, dim=-1), torch.logsumexp(logits, dim=-1) ** 2


def moe_mesh(ffns: Dict[Any, Dict], cfg: ModelConfig, x: Dict[Any, torch.Tensor],
             mesh) -> Tuple[Dict[Any, torch.Tensor], Dict[str, torch.Tensor]]:
    """Expert parallelism on a mesh, for training. ``ffns`` holds each
    position's MoE weights (the router whole; its own experts where
    ``model`` splits ``experts``, else its ``mlp`` columns where ``model``
    splits those, else all), ``x`` each position's copy of its batch
    shard's normed input (B_l, S, d).

    The routing groups are the whole microbatch's (:func:`group_size` of
    its global token count), as the reference's: groups that divide a
    batch shard's tokens stay on it; otherwise every batch shard gathers
    the microbatch over the batch's axes, routes and runs all its groups,
    and keeps its own rows. Each position runs :func:`moe_groups` on the
    experts it holds, and the partial outputs are summed over ``model``.
    The aux losses are the means over the global groups, taken once, at
    ``model`` index 0 (of the first batch shard, for gathered groups), in
    the microbatch's group order on the mesh's lead device, as one device
    takes them. Returns (each position's output, the aux losses)."""
    from repro_torch.sharding.placed import all_gather, all_reduce, axis_groups

    names = mesh.axis_names
    mi = names.index("model") if "model" in names else None
    positions = list(x)
    batch_axes = tuple(a for i, a in enumerate(names)
                       if a != "model" and len({p[i] for p in positions}) > 1)
    shard = {p: 0 for p in positions}
    if batch_axes:
        for members in axis_groups(mesh, batch_axes, positions):
            shard.update((p, i) for i, p in enumerate(members))
    b_l, s, d = x[positions[0]].shape
    n_shards = 1 + max(shard.values())
    gs = group_size(cfg, b_l * s * n_shards)
    local = (b_l * s) % gs == 0
    if not local:
        x = all_gather(x, mesh, batch_axes, 0)
    lp0 = next(iter(ffns.values()))
    e_l = lp0["w_up"].shape[0]
    split = e_l < cfg.num_experts or lp0["w_up"].shape[-1] < cfg.d_ff
    out, balance, lse2 = {}, [], []
    for pos, lp in ffns.items():
        owner = (mi is None or pos[mi] == 0) and (local or shard[pos] == 0)
        first = pos[mi] * e_l if e_l < cfg.num_experts else 0
        xs = x[pos]
        o, per_group, l2 = moe_groups(lp, cfg, xs.reshape(-1, gs, d), first, record=owner)
        o = o.reshape(xs.shape)
        out[pos] = o if local else o[shard[pos] * b_l:(shard[pos] + 1) * b_l]
        if owner:
            balance.append(per_group.to(mesh.lead))
            lse2.append(l2.to(mesh.lead))
    if split:
        out = all_reduce(out, mesh, "model")
    return out, aux_losses(cfg, torch.cat(balance).mean(), torch.cat(lse2).mean())
