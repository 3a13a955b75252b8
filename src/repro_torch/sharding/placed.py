"""Tree leaves placed on a mesh, and the collectives between their shards.

The reference places an array on a mesh with a ``NamedSharding`` and lets
GSPMD insert the collectives. The port is single-controller with no
compiler: a :class:`Placed` leaf holds one local shard per mesh position,
each a tensor on that position's device (``mesh.device(pos)``) with the
spec's shard shape, and the sharded step calls the collectives itself.

Memory is what a real mesh holds: a dim the spec splits is stored split,
and positions that differ only along a mesh axis the spec leaves out hold
one copy each (a replica), so on ``[cuda:0] * 4`` the card holds every
position's shard. A 0-d leaf (a step count) is not placed: it stays one
tensor on the mesh's lead device.

The collectives act over one mesh axis, or a tuple of axes taken as one
(the first major), on a dict ``{position: tensor}``: the positions that
differ only along the axis form a group, and each group's members are
taken in axis order. :func:`all_reduce` and :func:`reduce_scatter` sum in
that fixed order, ``((t0 + t1) + t2) + ...`` on the first member's device,
so a run repeats bit for bit; :func:`all_gather` concatenates in it.
:func:`all_reduce` and :func:`all_gather` are autograd Functions: the
gradient of an all-gather is the reduce-scatter of the members'
gradients, and that of an all-reduce the all-reduce of its copies'
gradients, in the same fixed order.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.sharding.rules import NamedSharding, PartitionSpec

__all__ = [
    "Placed",
    "distribute",
    "zeros",
    "gather",
    "place",
    "reduce_replicas",
    "all_reduce",
    "all_gather",
    "reduce_scatter",
    "axis_groups",
]

Pos = Tuple[int, ...]
Axes = Union[str, Tuple[str, ...]]


def _axes(axis: Axes) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _coord(mesh, pos: Pos, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """(index of ``pos`` along ``axes`` taken as one, the first major; their size)."""
    idx, size = 0, 1
    for a in axes:
        n = mesh.shape[a]
        idx, size = idx * n + pos[mesh.axis_names.index(a)], size * n
    return idx, size


def _check(shape: Sequence[int], mesh, spec: PartitionSpec) -> None:
    if len(spec) > len(shape):
        raise ValueError(f"{spec} has more entries than the {len(shape)}-d shape {tuple(shape)}")
    used = spec.used()
    unknown = [a for a in used if a not in mesh.axis_names]
    if unknown or len(set(used)) != len(used):
        raise ValueError(f"{spec} on a mesh of axes {mesh.axis_names}: unknown or repeated "
                         f"axes {unknown or used}")
    for dim in range(len(spec)):
        n = _coord(mesh, (0,) * len(mesh.axis_names), spec.axes(dim))[1]
        if shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split {n} ways ({spec})")


def _bounds(shape: Sequence[int], mesh, spec: PartitionSpec, pos: Pos) -> List[Tuple[int, int]]:
    """The [start, stop) of each dim that position ``pos`` holds."""
    out = []
    for dim, n in enumerate(shape):
        i, parts = _coord(mesh, pos, spec.axes(dim))
        step = n // parts
        out.append((i * step, (i + 1) * step))
    return out


def _slices(bounds) -> Tuple[slice, ...]:
    return tuple(slice(a, b) for a, b in bounds)


class Placed:
    """One leaf on a mesh: ``shards[pos]`` is position ``pos``'s slice of
    the global array of ``shape``, on ``mesh.device(pos)``, as ``spec``
    splits it."""

    __slots__ = ("mesh", "spec", "shape", "shards")

    def __init__(self, mesh, spec: PartitionSpec, shape: Sequence[int],
                 shards: Dict[Pos, torch.Tensor]):
        self.mesh, self.spec, self.shape = mesh, spec, torch.Size(shape)
        self.shards = shards

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.shards.values())).dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def local(self, pos: Pos) -> torch.Tensor:
        return self.shards[pos]

    def bounds(self, pos: Pos) -> List[Tuple[int, int]]:
        return _bounds(self.shape, self.mesh, self.spec, pos)

    def distinct(self) -> List[Pos]:
        """The positions holding distinct slices: index 0 along every mesh
        axis the spec leaves out (its replicas' axes). Together they cover
        the array once."""
        used = set(self.spec.used())
        free = [i for i, a in enumerate(self.mesh.axis_names) if a not in used]
        return [p for p in self.mesh.positions() if all(p[i] == 0 for i in free)]

    def map(self, fn) -> "Placed":
        """``fn`` over every shard (same shape, spec and mesh)."""
        return Placed(self.mesh, self.spec, self.shape,
                      {pos: fn(t) for pos, t in self.shards.items()})

    def __repr__(self) -> str:
        return (f"Placed(shape={tuple(self.shape)}, dtype={self.dtype}, spec={self.spec}, "
                f"mesh={self.mesh.shape})")


def distribute(tensor: torch.Tensor, mesh, spec: PartitionSpec):
    """``tensor`` split by ``spec``: each position gets its own copy of its
    slice, on its device. A 0-d tensor is moved to the mesh's lead device."""
    if tensor.ndim == 0:
        return tensor.to(mesh.lead)
    _check(tensor.shape, mesh, spec)
    shards = {}
    for pos in mesh.positions():
        piece = tensor[_slices(_bounds(tensor.shape, mesh, spec, pos))]
        shards[pos] = piece.to(mesh.device(pos), copy=True).contiguous()
    return Placed(mesh, spec, tensor.shape, shards)


def zeros(shape: Sequence[int], dtype: torch.dtype, mesh, spec: PartitionSpec) -> Placed:
    """Zeros of ``shape`` placed by ``spec``."""
    _check(shape, mesh, spec)
    shards = {}
    for pos in mesh.positions():
        sizes = [b - a for a, b in _bounds(shape, mesh, spec, pos)]
        shards[pos] = torch.zeros(sizes, dtype=dtype, device=mesh.device(pos))
    return Placed(mesh, spec, shape, shards)


def gather(placed, device=None) -> torch.Tensor:
    """The global array, assembled on ``device`` (default: the mesh's lead
    device) from the distinct shards. A plain tensor is moved as it is."""
    if not isinstance(placed, Placed):
        return placed.to(device if device is not None else placed.device)
    device = torch.device(device) if device is not None else placed.mesh.lead
    out = torch.empty(placed.shape, dtype=placed.dtype, device=device)
    for pos in placed.distinct():
        out[_slices(placed.bounds(pos))] = placed.local(pos).to(device)
    return out


def place(leaf, sharding: NamedSharding):
    """``leaf`` (a tensor, or a :class:`Placed` leaf of any mesh and spec) as
    ``sharding`` places it. From a placed leaf each new shard is copied
    from the old distinct shards it overlaps, so values move bit for bit
    and no position builds the whole array. A leaf already placed so is
    returned as it is."""
    mesh, spec = sharding.mesh, sharding.spec
    if not isinstance(leaf, Placed):
        return distribute(leaf, mesh, spec)
    if leaf.mesh is mesh and leaf.spec == spec:
        return leaf
    _check(leaf.shape, mesh, spec)
    sources = [(pos, leaf.bounds(pos)) for pos in leaf.distinct()]
    shards = {}
    for pos in mesh.positions():
        dev = mesh.device(pos)
        want = _bounds(leaf.shape, mesh, spec, pos)
        piece = torch.empty([b - a for a, b in want], dtype=leaf.dtype, device=dev)
        for src, have in sources:
            both = [(max(a0, a1), min(b0, b1)) for (a0, b0), (a1, b1) in zip(want, have)]
            if any(lo >= hi for lo, hi in both):
                continue
            dst = tuple(slice(lo - a, hi - a) for (lo, hi), (a, _b) in zip(both, want))
            part = tuple(slice(lo - a, hi - a) for (lo, hi), (a, _b) in zip(both, have))
            piece[dst] = leaf.local(src)[part].to(dev)
        shards[pos] = piece
    return Placed(mesh, spec, leaf.shape, shards)


# ---------------------------------------------------------------------------
# Collectives over one mesh axis
# ---------------------------------------------------------------------------

def axis_groups(mesh, axis: Axes, positions: Optional[Iterable[Pos]] = None) -> List[List[Pos]]:
    """The groups of positions that differ only along ``axis`` (its members
    in axis order), over ``positions`` (default: the whole mesh; a subset
    must hold whole groups)."""
    axes = _axes(axis)
    dims = [mesh.axis_names.index(a) for a in axes]
    groups: Dict[Pos, List[Tuple[int, Pos]]] = {}
    for pos in (mesh.positions() if positions is None else positions):
        key = tuple(0 if i in dims else c for i, c in enumerate(pos))
        groups.setdefault(key, []).append((_coord(mesh, pos, axes)[0], pos))
    size = math.prod(mesh.shape[a] for a in axes)
    out = []
    for members in groups.values():
        members.sort()
        if [i for i, _ in members] != list(range(size)):
            raise ValueError(f"positions {[p for _, p in members]} are not a whole group "
                             f"along {axes}")
        out.append([p for _, p in members])
    return out


def _ordered_sum(tensors: Sequence[Optional[torch.Tensor]]) -> Optional[torch.Tensor]:
    """((t0 + t1) + t2) + ... on the first one's device; None terms skipped."""
    total = None
    for t in tensors:
        if t is not None:
            total = t if total is None else total + t.to(total.device)
    return total


def _scatter(total: torch.Tensor, sizes: Sequence[int], dim: int,
             devices: Sequence[torch.device]) -> Tuple[torch.Tensor, ...]:
    return tuple(piece.to(dev, copy=True).contiguous()
                 for piece, dev in zip(torch.split(total, list(sizes), dim), devices))


class _AllGather(torch.autograd.Function):
    """Forward: the parts concatenated along ``dim``, one copy on each of
    ``devices``. Backward: the reduce-scatter of the copies' gradients."""

    @staticmethod
    def forward(ctx, dim, devices, *parts):
        ctx.dim, ctx.sizes = dim, [p.shape[dim] for p in parts]
        ctx.src = [p.device for p in parts]
        return tuple(torch.cat([p.to(dev) for p in parts], dim) for dev in devices)

    @staticmethod
    def backward(ctx, *grads):
        total = _ordered_sum(grads)
        if total is None:
            return (None, None) + (None,) * len(ctx.src)
        return (None, None) + _scatter(total, ctx.sizes, ctx.dim, ctx.src)


class _AllReduce(torch.autograd.Function):
    """Forward: the parts' sum in order, one copy on each of ``devices``.
    Backward: each part's gradient is the copies' gradients summed in
    order."""

    @staticmethod
    def forward(ctx, devices, *parts):
        ctx.src = [p.device for p in parts]
        total = _ordered_sum(parts)
        return tuple(total.to(dev, copy=True) for dev in devices)

    @staticmethod
    def backward(ctx, *grads):
        total = _ordered_sum(grads)
        if total is None:
            return (None,) * (1 + len(ctx.src))
        return (None,) + tuple(total.to(dev, copy=True) for dev in ctx.src)


def all_gather(values: Dict[Pos, torch.Tensor], mesh, axis: Axes,
               dim: int) -> Dict[Pos, torch.Tensor]:
    """Each member of a group gets its group's tensors concatenated along
    ``dim`` in axis order (differentiable: its gradient is the
    reduce-scatter)."""
    out = {}
    for members in axis_groups(mesh, axis, values):
        outs = _AllGather.apply(dim, [mesh.device(p) for p in members],
                                *(values[p] for p in members))
        out.update(zip(members, outs))
    return out


def all_reduce(values: Dict[Pos, torch.Tensor], mesh, axis: Axes) -> Dict[Pos, torch.Tensor]:
    """Each member of a group gets its group's sum, taken in axis order
    (differentiable)."""
    out = {}
    for members in axis_groups(mesh, axis, values):
        outs = _AllReduce.apply([mesh.device(p) for p in members],
                                *(values[p] for p in members))
        out.update(zip(members, outs))
    return out


def reduce_scatter(values: Dict[Pos, torch.Tensor], mesh, axis: Axes,
                   dim: int) -> Dict[Pos, torch.Tensor]:
    """Each group's sum (in axis order) split along ``dim``: member ``i``
    gets piece ``i``."""
    out = {}
    for members in axis_groups(mesh, axis, values):
        total = _ordered_sum([values[p] for p in members])
        n = len(members)
        if total.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(total.shape)} does not split {n} ways")
        pieces = _scatter(total, [total.shape[dim] // n] * n, dim,
                          [mesh.device(p) for p in members])
        out.update(zip(members, pieces))
    return out


def reduce_replicas(placed: Placed) -> Placed:
    """Sum the replicas of ``placed`` (gradients): an all-reduce over every
    mesh axis its spec leaves out, one axis after another in mesh order.
    A replicated parameter's replicas each got the gradient of the
    positions that used them; the sum is the parameter's gradient."""
    used = set(placed.spec.used())
    shards = placed.shards
    with torch.no_grad():
        for axis in placed.mesh.axis_names:
            if axis not in used and placed.mesh.shape[axis] > 1:
                shards = all_reduce(shards, placed.mesh, axis)
    return Placed(placed.mesh, placed.spec, placed.shape, shards)
