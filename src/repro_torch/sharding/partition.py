"""Apply logical-axes trees to parameter trees -> spec and sharding trees,
plus the image-layout helpers the multi-device edge engine places with.

The port of ``repro.sharding.partition``. An axes tree has the structure
of the state (nested dicts and NamedTuples) with a tuple of logical axis
names (or None) at each leaf; ``()`` is a scalar's.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

from repro_torch.sharding.rules import NamedSharding, PartitionSpec, logical_to_spec
from repro_torch.tree import is_namedtuple, tree_map

__all__ = [
    "specs_for_tree",
    "shardings_for_tree",
    "replicated",
    "layout_logical_axes",
    "image_spec",
    "map_axes",
]


def layout_logical_axes(layout: str) -> Tuple[Optional[str], ...]:
    """Logical image axes for a ``repro_torch.api`` layout string.

    Every leading batch dim (``N``/``T``) is ``batch`` on the first and
    unsharded after that (one data axis); ``H``/``W``/``C`` map to
    ``height``/``width``/``channel``.
    """
    table = {"H": "height", "W": "width", "C": "channel"}
    axes = []
    seen_batch = False
    for ch in layout:
        if ch in table:
            axes.append(table[ch])
        else:
            axes.append(None if seen_batch else "batch")
            seen_batch = True
    return tuple(axes)


def image_spec(layout: str, mesh, shape: Optional[Tuple[int, ...]] = None) -> PartitionSpec:
    """PartitionSpec for an image batch of ``layout`` on ``mesh`` under the
    image rule set (batch -> data, height -> row, width -> col)."""
    return logical_to_spec(layout_logical_axes(layout), mesh, shape, rules="image")


def _is_axes(node: Any) -> bool:
    return (isinstance(node, tuple) and not is_namedtuple(node)
            and all(a is None or isinstance(a, str) for a in node))


def map_axes(fn: Callable, axes_tree: Any, *rest: Any) -> Any:
    """``fn(axes, *matching leaves of rest)`` over an axes tree, whose
    leaves are tuples of logical names; dicts and NamedTuples are walked,
    and the structure is kept."""
    if _is_axes(axes_tree):
        return fn(axes_tree, *rest)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, axes_tree[k], *(r[k] for r in rest)) for k in sorted(axes_tree)}
    if is_namedtuple(axes_tree):
        return type(axes_tree)(*(map_axes(fn, v, *(r[i] for r in rest))
                                 for i, v in enumerate(axes_tree)))
    raise TypeError(f"not an axes tree node: {axes_tree!r}")


def specs_for_tree(axes_tree: Any, mesh, shape_tree: Any = None, rules=None) -> Any:
    """Map an axes tree to a tree of PartitionSpec. ``shape_tree`` (leaves
    with ``.shape``: tensors, ``meta`` tensors) enables divisibility-aware
    degradation."""
    if shape_tree is None:
        return map_axes(lambda axes: logical_to_spec(axes, mesh, rules=rules), axes_tree)
    return map_axes(lambda axes, s: logical_to_spec(axes, mesh, tuple(s.shape), rules=rules),
                    axes_tree, shape_tree)


def shardings_for_tree(axes_tree: Any, mesh, shape_tree: Any = None, rules=None) -> Any:
    specs = specs_for_tree(axes_tree, mesh, shape_tree, rules=rules)
    return tree_map(lambda s: NamedSharding(mesh, s), specs)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
