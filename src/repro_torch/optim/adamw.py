"""AdamW with global-norm clipping and ZeRO-1 optimizer-state sharding: the
port of ``repro.optim.adamw``.

Functional, as the reference's:
    state = init(params)
    new_params, new_state, stats = update(grads, state, params, lr, ...)

``update`` clips by the global norm, corrects the moments' bias and decays
the weights decoupled from the gradient, in the reference's order and in
f32; it returns new tensors and leaves ``params`` and ``state`` as they
were (a retried step reuses them).

ZeRO-1: :func:`opt_state_axes` gives the moments each parameter's logical
axes with ``zero1`` (sharded over ``data``) on the largest dim that is
still unsharded and divisible by ``|data|``. On a mesh the leaves are
:class:`~repro_torch.sharding.placed.Placed`: the clip uses the global
norm (each distinct shard's sum of squares, summed once across the mesh),
and the element-wise step runs at every position on its own shard, in the
moments' layout (a gradient and weight laid out otherwise are re-placed to
it first, and the new weight back): the classic ZeRO-1 schedule that
GSPMD derives in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.sharding.placed import Placed, place
from repro_torch.sharding.rules import NamedSharding, get_rules
from repro_torch.tree import leaves, tree_map, unflatten

__all__ = ["AdamWState", "init", "update", "opt_state_axes", "global_norm"]


class AdamWState(NamedTuple):
    count: torch.Tensor      # int32 scalar: the updates taken
    mu: Any                  # first moments, f32, the params' tree
    nu: Any                  # second moments, f32


def init(params: Any) -> AdamWState:
    first = leaves(params)[0]
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)   # noqa: E731
    return AdamWState(count=torch.zeros((), dtype=torch.int32, device=first.device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def _sum_squares(leaf) -> torch.Tensor:
    """A leaf's sum of squares in f32; a placed leaf's is the sum, in
    position order on the lead device, of its distinct shards' (a replica
    counts once)."""
    if not isinstance(leaf, Placed):
        return leaf.float().square().sum()
    total = None
    for pos in leaf.distinct():
        sq = leaf.local(pos).float().square().sum().to(leaf.mesh.lead)
        total = sq if total is None else total + sq
    return total


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over the leaves (in ``jax.tree`` order) of each
    leaf's sum of squares, in f32."""
    total = None
    for leaf in leaves(tree):
        sq = _sum_squares(leaf)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def update(
    grads: Any,
    state: AdamWState,
    params: Any,
    lr,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: Optional[float] = 1.0,
) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step. ``lr`` is a float or a scalar tensor; ``stats``
    holds the pre-clip ``grad_norm``."""
    gnorm = global_norm(grads)
    scale = None
    if clip_norm is not None:
        scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)

    count = state.count + 1
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()

    def _upd(g, m, v, p):
        # the reference scales the whole tree first (promoting to f32);
        # leaf by leaf is the same product and holds no second grads tree
        dev = g.device          # a mesh position's: the scalars live on the lead device
        g = g.float() if scale is None else g.float() * scale.to(dev)
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        step = (m / c1.to(dev)) / (torch.sqrt(v / c2.to(dev)) + eps)
        step = step + weight_decay * p.float()
        new_p = p.float() - lr * step
        return new_p.to(p.dtype), m, v

    def _upd_placed(g, m, v, p):
        layout = NamedSharding(m.mesh, m.spec)
        g, p_m = place(g, layout), place(p, layout)
        out = {pos: _upd(*(t.local(pos) for t in (g, m, v, p_m))) for pos in m.mesh.positions()}
        new_p, new_m, new_v = (Placed(m.mesh, m.spec, m.shape, {pos: o[i] for pos, o in out.items()})
                               for i in range(3))
        return place(new_p, NamedSharding(p.mesh, p.spec)), new_m, new_v

    out = [(_upd_placed if isinstance(t[1], Placed) else _upd)(*t)
           for t in zip(*(leaves(x) for x in (grads, state.mu, state.nu, params)))]
    new_p, new_m, new_v = (unflatten(params, [o[i] for o in out]) for i in range(3))
    return new_p, AdamWState(count, new_m, new_v), {"grad_norm": gnorm}


def opt_state_axes(param_axes: Any, param_shapes: Any, mesh) -> AdamWState:
    """Logical axes for AdamWState: the params' axes plus ZeRO-1 ``zero1``
    (sharded over ``data``) on the largest dim that is still unsharded in
    train mode and divisible by |data|."""
    from repro_torch.sharding.partition import map_axes

    data_size = mesh.shape["data"] if "data" in mesh.axis_names else 1
    train_rules = get_rules("train")

    def _unmapped(name) -> bool:
        return name is None or not any(train_rules.get(name, ()))

    def zero1(axes, shape):
        axes, dims = list(axes), tuple(shape.shape)
        if data_size > 1:
            for i in sorted(range(len(dims)), key=lambda i: -dims[i]):
                if _unmapped(axes[i]) and dims[i] % data_size == 0:
                    axes[i] = "zero1"
                    break
        return tuple(axes)

    moment_axes = map_axes(zero1, param_axes, param_shapes)
    return AdamWState(count=(), mu=moment_axes, nu=moment_axes)
