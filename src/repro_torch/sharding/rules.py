"""Logical-axis -> mesh-axis sharding rules, organized as named rule sets.

The port of ``repro.sharding.rules``, with its own copy of the tables. The
image rule set maps image logical axes onto the image mesh ``(data, row,
col)``:

  * ``batch``   -> ``data``  (independent frames);
  * ``height``  -> ``row``   (spatial row bands, stitched by the halo
                   exchange of ``sharding.halo``);
  * ``width``   -> ``col``   (spatial column bands);
  * ``channel`` -> replicated.

``height`` falls back onto the LM ``model`` axis, so an image batch placed
on a ``(pod, data, model)`` mesh still spreads its rows (``width`` gets no
fallback: a mesh axis is never used twice).

The LM architectures keep the MaxText-style rule set (``heads``,
``kv_heads``, ``mlp``, ``vocab``, ``experts`` -> ``model``; ZeRO-1
optimizer state -> ``data``; FSDP overrides in train mode). Both sets are
merged into one default table (the names are disjoint, and ``batch``
means the same in both).

Rules degrade: a mesh axis is dropped for an array dim it does not divide
(llama3.2-1b SMOKE's 2 KV heads on a 4-way ``model`` axis), so one table
serves every architecture and mesh.

A mesh here is anything with ``axis_names`` and a ``shape`` mapping from
axis name to size: the port's single-controller meshes
(``runtime.elastic.Mesh``, ``ImageMesh``). Specs are the port's own
:class:`PartitionSpec`.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Any, Dict, Optional, Sequence, Tuple

__all__ = [
    "IMAGE_RULES",
    "LM_RULES",
    "DEFAULT_RULES",
    "TRAIN_OVERRIDES",
    "TRAIN_RULES",
    "PartitionSpec",
    "NamedSharding",
    "logical_to_spec",
    "sharding_for",
    "activation_shard",
    "mesh_context",
    "current_mesh",
    "current_rules",
    "get_rules",
]

Rules = Tuple[Tuple[str, Tuple[Tuple[str, ...], ...]], ...]


class PartitionSpec:
    """How each dim of an array splits over mesh axes: per dim ``None``
    (replicated), one axis name, or a tuple of names (split over their
    product, the first one major). Dims past the end are replicated.
    Compares equal to another spec with the same entries; ``tuple(spec)``
    gives them, as ``tuple`` of a JAX ``PartitionSpec`` does."""

    __slots__ = ("_parts",)

    def __init__(self, *parts):
        for p in parts:
            if not (p is None or isinstance(p, str)
                    or (isinstance(p, tuple) and all(isinstance(a, str) for a in p))):
                raise TypeError(f"a spec entry is None, an axis name or a tuple of names, "
                                f"not {p!r}")
        self._parts = tuple(parts)

    def __iter__(self):
        return iter(self._parts)

    def __len__(self) -> int:
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionSpec) and self._parts == other._parts

    def __hash__(self) -> int:
        return hash(self._parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{self._parts!r}"

    def axes(self, dim: int) -> Tuple[str, ...]:
        """The mesh axes dim ``dim`` splits over (``()`` for none)."""
        p = self._parts[dim] if dim < len(self._parts) else None
        return () if p is None else (p,) if isinstance(p, str) else p

    def used(self) -> Tuple[str, ...]:
        """Every mesh axis the spec splits a dim over, in dim order."""
        return tuple(a for i in range(len(self._parts)) for a in self.axes(i))


class NamedSharding:
    """A spec on a mesh: where each slice of an array lives."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, spec

    def __repr__(self) -> str:
        return f"NamedSharding({dict(self.mesh.shape)}, {self.spec!r})"


# ---------------------------------------------------------------------------
# Rule tables. Each entry: logical axis -> mesh-axis options, tried in order;
# the first option whose axes all exist in the mesh, are unused, and divide
# the dim wins.
# ---------------------------------------------------------------------------

IMAGE_RULES: Rules = (
    ("height", (("row",), ("model",))),
    ("width", (("col",),)),
    ("channel", ()),
)

# Params are TP-sharded over `model` and replicated over `data` (serve);
# optimizer state is ZeRO-1 sharded over `data` (see optim/adamw.py).
LM_RULES: Rules = (
    ("embed", ()),
    ("embed_td", (("model",),)),  # d-sharded embedding table (local gather)
    ("heads", (("model",),)),
    ("kv_heads", (("model",),)),
    ("head_dim", ()),
    ("qk_rank", (("model",),)),
    ("kv_rank", (("model",),)),
    ("mlp", (("model",),)),
    ("experts", (("model",),)),
    ("groups", (("pod", "data"), ("data",))),
    ("vocab", (("model",),)),
    ("table_vocab", ()),
    ("kv_len", (("model",),)),
    ("attn_seq", (("model",),)),  # sequence-parallel attention fallback
    ("ssm_inner", (("model",),)),
    ("ssm_heads", (("model",),)),
    ("zero1", (("data",),)),  # ZeRO-1 optimizer-state sharding
    ("layers", ()),
    ("stack", ()),
)

_BATCH_RULE: Rules = (
    ("batch", (("pod", "data"), ("data",))),  # composite first, fallback
)

DEFAULT_RULES: Rules = _BATCH_RULE + IMAGE_RULES + LM_RULES

_RULES = {name: opts for name, opts in DEFAULT_RULES}
_IMAGE_RULES = {name: opts for name, opts in _BATCH_RULE + IMAGE_RULES}

# Train mode: FSDP. Weights' d_model and vocab-table dims shard over `data`
# (each position gathers them before use and the gradients are
# reduce-scattered back), composed with TP over `model`. Pods replicate:
# the cross-pod axis carries one gradient all-reduce a step.
TRAIN_OVERRIDES = {
    "embed": (("data",),),
    "table_vocab": (("data",),),
}
TRAIN_RULES = dict(_RULES, **TRAIN_OVERRIDES)


def get_rules(mode: str = "serve") -> Dict[str, Tuple[Tuple[str, ...], ...]]:
    """Rule table by mode: ``serve`` (default), ``train`` (FSDP overrides),
    or ``image`` (image axes only: what ``sharding.halo`` places with)."""
    if mode == "train":
        return TRAIN_RULES
    if mode == "image":
        return _IMAGE_RULES
    return _RULES


def _axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh.shape[a] for a in axes)


def logical_to_spec(
    logical_axes: Sequence[Optional[str]],
    mesh,
    shape: Optional[Sequence[int]] = None,
    rules=None,
) -> PartitionSpec:
    """Map a tuple of logical axis names (or None) to a PartitionSpec.

    If ``shape`` is given, mesh axes that do not divide the corresponding dim
    are dropped, and a mesh axis is never used twice. ``rules`` may be a
    dict or a mode string ("train" | "serve" | "image"). Trailing
    replicated dims are left out.
    """
    if isinstance(rules, str):
        rules = get_rules(rules)
    rules = rules or _RULES
    used: set = set()
    out = []
    for i, name in enumerate(logical_axes):
        if name is None:
            out.append(None)
            continue
        options = rules.get(name)
        if options is None:
            raise KeyError(f"no sharding rule for logical axis {name!r}")
        chosen = None
        for opt in options:
            axes = tuple(a for a in (opt if isinstance(opt, tuple) else (opt,))
                         if a in mesh.axis_names)
            if not axes or any(a in used for a in axes):
                continue
            if shape is not None and shape[i] % _axis_size(mesh, axes) != 0:
                continue
            chosen = axes
            break
        if chosen:
            used.update(chosen)
            out.append(chosen if len(chosen) > 1 else chosen[0])
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def sharding_for(
    logical_axes: Sequence[Optional[str]],
    mesh,
    shape: Optional[Sequence[int]] = None,
    rules=None,
) -> NamedSharding:
    return NamedSharding(mesh, logical_to_spec(logical_axes, mesh, shape, rules=rules))


# ---------------------------------------------------------------------------
# Mesh context for activation sharding inside model code
# ---------------------------------------------------------------------------

_ctx = threading.local()


@contextmanager
def mesh_context(mesh, rules=None):
    prev = (getattr(_ctx, "mesh", None), getattr(_ctx, "rules", None))
    _ctx.mesh = mesh
    _ctx.rules = rules
    try:
        yield
    finally:
        _ctx.mesh, _ctx.rules = prev


def current_mesh():
    return getattr(_ctx, "mesh", None)


def current_rules():
    return getattr(_ctx, "rules", None)


def activation_shard(x: Any, *logical_axes: Optional[str]) -> Any:
    """The reference's ``with_sharding_constraint`` by logical axes. Returns
    ``x`` unchanged: the port has no compiler to hint, and its sharded step
    (``models/transformer.mesh_loss``) places every activation itself, one
    tensor per mesh position. The spec is still resolved under the
    installed mesh and rules, so a logical axis with no rule raises here
    as it does in the reference."""
    mesh = current_mesh()
    if mesh is not None and math.prod(mesh.shape.values()) > 1:
        logical_to_spec(logical_axes, mesh, getattr(x, "shape", None), rules=current_rules())
    return x
