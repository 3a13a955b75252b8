"""Elastic scaling: plan the mesh for the devices that are left, build it
again after a device loss or an excluded straggler, and move live state
onto it.

The port of ``repro.runtime.elastic``. The reference is single-controller:
one process holds ``jax.devices()`` and maps a ``Mesh`` of them. The port
keeps that shape: a mesh is a grid of ``torch.device`` objects in one
process. A device may appear in it more than once, as the reference's
tests fake 8 host devices: ``[torch.device("cuda:0")] * 8`` runs a real
2x2x2 mesh on one card. A device loss is a new mesh over fewer devices,
not a process group that loses a rank. Two mesh families share one policy
(a parallelism degree that is a property of the workload survives device
loss; pure data parallelism shrinks first):

  * LM meshes, :class:`Mesh` with axes ``("data", "model")`` or ``("pod",
    "data", "model")``: :func:`plan_mesh` keeps the ``model`` axis if it
    can (the TP degree is a property of the checkpointed layout) and
    shrinks ``data``; :func:`make_mesh` builds it; :func:`reshard` moves
    a state tree onto it by its logical axes, so a job that loses a
    device continues on a smaller data axis.
  * Image meshes, :class:`ImageMesh` with axes ``("data", "row",
    "col")``: :func:`plan_image_mesh` keeps the spatial ``row x col`` grid
    if the survivors can carry it (the spatial degree is what the tiles
    were tuned for; see ``repro_torch.sharding.halo``) and shrinks
    ``data`` first; only when they cannot does it halve the larger spatial
    axis.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

__all__ = [
    "IMAGE_MESH_AXES",
    "ImageMesh",
    "Mesh",
    "plan_mesh",
    "make_mesh",
    "reshard",
    "plan_image_mesh",
    "make_image_mesh",
    "visible_devices",
]

IMAGE_MESH_AXES = ("data", "row", "col")


def plan_mesh(n_devices: int, *, model_parallel: int = 1,
              pods: int = 1) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest mesh shape for ``n_devices``: (pod, data, model) or (data, model)."""
    model = model_parallel
    while model > 1 and (n_devices % model != 0 or n_devices < model):
        model //= 2
    per_pod = n_devices // pods if pods > 1 and n_devices % pods == 0 else n_devices
    if pods > 1 and n_devices % pods == 0 and per_pod % model == 0:
        return (pods, per_pod // model, model), ("pod", "data", "model")
    data = n_devices // model
    return (data, model), ("data", "model")


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as the current CUDA device's ``cuda:N``, so a position's
    device compares equal to its tensors' ``.device``."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """An LM mesh: a grid of devices in one process, with axes ``("data",
    "model")`` or ``("pod", "data", "model")``. ``shape`` maps each axis
    name to its size (in axis order), as a JAX ``Mesh`` does; a position
    is a tuple of indices, one per axis, and ``device(pos)`` is where its
    shards live. Positions are walked in C order (the last axis fastest)."""

    def __init__(self, devices: Sequence[torch.device], shape: Sequence[int],
                 axis_names: Sequence[str]):
        shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or min(shape, default=0) < 1:
            raise ValueError(f"a mesh of shape {shape} over axes {axis_names}")
        if len(devices) != math.prod(shape):
            raise ValueError(f"a {shape} mesh takes {math.prod(shape)} devices, "
                             f"got {len(devices)}")
        self._devices = tuple(_indexed(torch.device(d)) for d in devices)
        self._shape = shape
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self._shape))

    @property
    def size(self) -> int:
        return len(self._devices)

    @property
    def lead(self) -> torch.device:
        """The first position's device: scalars and gathered results land there."""
        return self._devices[0]

    def positions(self) -> Iterator[Tuple[int, ...]]:
        for flat in range(self.size):
            pos = []
            for n in reversed(self._shape):
                pos.append(flat % n)
                flat //= n
            yield tuple(reversed(pos))

    def device(self, pos: Tuple[int, ...]) -> torch.device:
        flat = 0
        for i, n in zip(pos, self._shape):
            flat = flat * n + i
        return self._devices[flat]

    def flat(self) -> List[torch.device]:
        """Every position's device, in position order (as ``ImageMesh.flat``)."""
        return list(self._devices)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self._devices]})"


def make_mesh(devices: Optional[Sequence] = None, *, model_parallel: int = 1,
              pods: int = 1) -> Mesh:
    """The largest LM mesh over ``devices`` (default: every visible CUDA
    device) by :func:`plan_mesh`."""
    devices = [torch.device(d) for d in devices] if devices is not None else visible_devices()
    if not devices:
        raise ValueError("a mesh needs at least one device")
    shape, axes = plan_mesh(len(devices), model_parallel=model_parallel, pods=pods)
    return Mesh(devices[: math.prod(shape)], shape, axes)


def reshard(state: Any, axes_tree: Any, new_mesh: Mesh, shape_tree: Any = None,
            rules=None) -> Any:
    """Move ``state`` onto ``new_mesh`` according to its logical axes.

    ``state``'s leaves are tensors (placed whole) or
    :class:`~repro_torch.sharding.placed.Placed` leaves of another mesh
    (each new shard copied from the old shards it overlaps, so the values
    stay bit for bit). ``shape_tree`` (leaves with ``.shape``) turns on the
    rules' divisibility degradation, as in the reference; ``rules`` picks
    the table ("train" | "serve" | "image" or a dict)."""
    # Deferred: sharding.halo imports this module for the image mesh.
    from repro_torch.sharding.partition import shardings_for_tree
    from repro_torch.sharding.placed import place
    from repro_torch.tree import tree_map

    shardings = shardings_for_tree(axes_tree, new_mesh, shape_tree, rules=rules)
    return tree_map(place, state, shardings)


def plan_image_mesh(
    n_devices: int, *, rows: int = 1, cols: int = 1, data: int = 0
) -> Tuple[Tuple[int, int, int], Tuple[str, str, str]]:
    """Largest ``(data, row, col)`` image mesh for ``n_devices``.

    The requested spatial grid is kept if it fits (halving the larger
    spatial axis until it does); ``data`` fills the remaining devices
    (``data=0``) or is clamped down to what the survivors can carry: losing
    half the devices halves throughput, not the spatial layout.
    """
    rows, cols = max(1, rows), max(1, cols)
    while rows * cols > n_devices:
        if rows >= cols and rows > 1:
            rows //= 2
        elif cols > 1:
            cols //= 2
        else:
            rows //= 2
    spatial = rows * cols
    fill = n_devices // spatial
    d = min(data, fill) if data else fill
    return (max(1, d), rows, cols), IMAGE_MESH_AXES


@dataclasses.dataclass(frozen=True)
class ImageMesh:
    """A ``(data, row, col)`` grid of devices in one process.

    ``devices[g][i][j]`` holds data group ``g``'s shard of row band ``i``
    and column band ``j``. ``shape`` maps each axis name to its size, as a
    JAX ``Mesh`` does.
    """

    devices: Tuple[Tuple[Tuple[torch.device, ...], ...], ...]

    def __post_init__(self):
        d = len(self.devices)
        r = len(self.devices[0]) if d else 0
        c = len(self.devices[0][0]) if r else 0
        if not (d and r and c) or any(
                len(g) != r or any(len(row) != c for row in g) for g in self.devices):
            raise ValueError("an image mesh is a non-empty (data, row, col) grid of devices")

    axis_names = IMAGE_MESH_AXES

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "row": len(self.devices[0]),
                "col": len(self.devices[0][0])}

    @property
    def size(self) -> int:
        d, r, c = self.shape.values()
        return d * r * c

    @property
    def lead(self) -> torch.device:
        """The first device: requests land there and results gather there."""
        return self.devices[0][0][0]

    def flat(self) -> List[torch.device]:
        return [dev for g in self.devices for row in g for dev in row]


def visible_devices() -> List[torch.device]:
    """Every visible CUDA device; raises when there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device is visible; pass devices=[...] (e.g. "
            "[torch.device('cpu')] * 8) to build a mesh on the CPU"
        )
    return [torch.device(f"cuda:{i}") for i in range(n)]


def make_image_mesh(
    devices: Optional[Sequence] = None, *, rows: int = 1, cols: int = 1, data: int = 0
) -> ImageMesh:
    """Image mesh over ``devices`` (default: every visible CUDA device)."""
    devices = [torch.device(d) for d in devices] if devices is not None else visible_devices()
    if not devices:
        raise ValueError("an image mesh needs at least one device")
    (d, r, c), _ = plan_image_mesh(len(devices), rows=rows, cols=cols, data=data)
    it = iter(devices[: d * r * c])
    return ImageMesh(tuple(tuple(tuple(next(it) for _ in range(c)) for _ in range(r))
                           for _ in range(d)))
