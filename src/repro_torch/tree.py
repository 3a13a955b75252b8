"""Trees of tensors: the few of ``jax.tree``'s functions that the training
half needs, over the containers it uses. Parameters are nested dicts;
``TrainState`` and ``AdamWState`` are NamedTuples; anything else is a leaf.

Dict keys are walked in sorted order, as ``jax.tree`` flattens them, so a
sum over :func:`leaves` adds in the reference's order.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["tree_map", "leaves", "leaves_with_path", "unflatten", "is_namedtuple"]


def is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); the structure is kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def leaves_with_path(tree: Any, path: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in flatten order. A path's parts are written as
    ``jax.tree_util`` prints its keys: a dict key as itself, a NamedTuple
    field as ``.name``, a sequence index as its number."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaves_with_path(tree[k], path + (str(k),))]
    if is_namedtuple(tree):
        return [p for name, v in zip(tree._fields, tree)
                for p in leaves_with_path(v, path + (f".{name}",))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in leaves_with_path(v, path + (str(i),))]
    return [(path, tree)]


def leaves(tree: Any) -> list:
    return [leaf for _path, leaf in leaves_with_path(tree)]


def unflatten(template: Any, new_leaves) -> Any:
    """``template``'s structure with ``new_leaves`` (in flatten order) as
    its leaves."""
    it = iter(new_leaves)
    out = tree_map(lambda _leaf: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out
