"""AdamW with global-norm clipping: the port of ``repro.optim.adamw`` on one
device.

Functional, as the reference's:
    state = init(params)
    new_params, new_state, stats = update(grads, state, params, lr, ...)

``update`` clips by the global norm, corrects the moments' bias and decays
the weights decoupled from the gradient, in the reference's order and in
f32; it returns new tensors and leaves ``params`` and ``state`` as they
were (a retried step reuses them). ZeRO-1's ``opt_state_axes`` waits for
the sharding rules (ROADMAP queue 1 item 13.7).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten

__all__ = ["AdamWState", "init", "update", "global_norm"]


class AdamWState(NamedTuple):
    count: torch.Tensor      # int32 scalar: the updates taken
    mu: Any                  # first moments, f32, the params' tree
    nu: Any                  # second moments, f32


def init(params: Any) -> AdamWState:
    first = leaves(params)[0]
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)   # noqa: E731
    return AdamWState(count=torch.zeros((), dtype=torch.int32, device=first.device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over the leaves (in ``jax.tree`` order) of each
    leaf's sum of squares, in f32."""
    total = None
    for leaf in leaves(tree):
        sq = leaf.float().square().sum()
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
        g = g.float() if scale is None else g.float() * scale
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        step = (m / c1) / (torch.sqrt(v / c2) + eps)
        step = step + weight_decay * p.float()
        new_p = p.float() - lr * step
        return new_p.to(p.dtype), m, v

    out = [_upd(*t) for t in zip(*(leaves(x) for x in (grads, state.mu, state.nu, params)))]
    new_p, new_m, new_v = (unflatten(params, [o[i] for o in out]) for i in range(3))
    return new_p, AdamWState(count, new_m, new_v), {"grad_norm": gnorm}
