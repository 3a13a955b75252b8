"""Gradient compression for a cross-shard all-reduce: int8 quantized sum with
error feedback (the 1-bit-Adam/QSGD-style trick). The port of
``repro.optim.compress``.

The reference runs these inside ``shard_map``, each device holding its
local value and ``psum``/``pmax`` reducing over a named axis. Here a local
value is one shard of a :class:`~repro_torch.sharding.placed.Placed` leaf
(its positions' unreduced values, e.g. a gradient before
``placed.reduce_replicas``), and the reductions run over the positions
that differ only along ``axis`` (``placed.axis_groups``). As in the
reference these functions are a library: the trainer's all-reduce stays
uncompressed.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.sharding.placed import Placed, axis_groups
from repro_torch.tree import leaves, tree_map, unflatten

__all__ = ["compressed_psum", "compress_tree_psum", "init_error_state"]


def _levels(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


def _group_scale(vals) -> torch.Tensor:
    """pmax of max|v| over a group, f32, at least 1e-30, on the first
    member's device."""
    lead = vals[0].device
    scale = torch.stack([v.abs().max().float().to(lead) for v in vals]).max()
    return torch.clamp(scale, min=1e-30)


def _quantize(v: torch.Tensor, scale: torch.Tensor, levels: float) -> torch.Tensor:
    """round(v / scale * levels), clipped to +-levels (f32)."""
    q = torch.round(v.float() / scale.to(v.device) * levels)
    return torch.clamp(q, -levels, levels)


def compressed_psum(x: Placed, axis, *, bits: int = 8) -> Placed:
    """All-reduce ``x``'s shards over ``axis`` in ``bits``-bit fixed point.

    Scale = the group's max|x| (one f32 max-reduce), then each shard moves
    as int8/int16 and the sum is taken in int32 (overflow-free for up to
    2^(31-bits) shards); every member gets ``sum * (scale / levels)``."""
    levels = _levels(bits)
    itype = torch.int8 if bits <= 8 else torch.int16
    out = {}
    for members in axis_groups(x.mesh, axis, x.shards):
        vals = [x.local(p) for p in members]
        scale = _group_scale(vals)
        lead = scale.device
        total = None
        for v in vals:
            q = _quantize(v, scale, levels).to(itype).to(torch.int32).to(lead)
            total = q if total is None else total + q
        reduced = total.float() * (scale / levels)
        out.update({p: reduced.to(x.mesh.device(p), copy=True) for p in members})
    return Placed(x.mesh, x.spec, x.shape, out)


def init_error_state(grads: Any) -> Any:
    """Zero residuals in f32, placed as ``grads``."""
    return tree_map(lambda g: g.map(lambda t: torch.zeros_like(t, dtype=torch.float32)), grads)


def compress_tree_psum(grads: Any, error: Any, axis, *, bits: int = 8) -> Tuple[Any, Any]:
    """Error-feedback compressed all-reduce (mean) over a tree of placed
    gradients.

    Returns (reduced_grads, new_error): each shard's quantization residual
    is carried and re-injected next step, so the compression bias
    telescopes away."""
    levels = _levels(bits)

    def one(g: Placed, e: Placed):
        corrected = Placed(g.mesh, g.spec, g.shape,
                           {p: t.float() + e.local(p) for p, t in g.shards.items()})
        reduced = compressed_psum(corrected, axis, bits=bits)
        new_e, mean = {}, {}
        for members in axis_groups(g.mesh, axis, g.shards):
            scale = _group_scale([corrected.local(p) for p in members])
            for p in members:
                c = corrected.local(p)
                sent = _quantize(c, scale, levels) * (scale.to(c.device) / levels)
                new_e[p] = c - sent
                mean[p] = reduced.local(p) / len(members)
        return (Placed(g.mesh, g.spec, g.shape, mean),
                Placed(g.mesh, g.spec, g.shape, new_e))

    out = [one(g, e) for g, e in zip(leaves(grads), leaves(error))]
    return unflatten(grads, [o[0] for o in out]), unflatten(grads, [o[1] for o in out])
