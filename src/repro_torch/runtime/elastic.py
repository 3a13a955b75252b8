"""Elastic image meshes: plan the mesh for the devices that are left and
build it again after a device loss or an excluded straggler.

The port of the image half of ``repro.runtime.elastic``. The reference is
single-controller: one process holds ``jax.devices()`` and maps a ``Mesh``
of them. The port keeps that shape: an :class:`ImageMesh` is a grid of
``torch.device`` objects in one process, with axes ``("data", "row",
"col")``. A device may appear in it more than once, as the reference's
tests fake 8 host devices: ``[torch.device("cuda:0")] * 8`` runs a real
2x2x2 mesh, halo exchange included, on one card. A device loss is a new
mesh over fewer devices (:func:`make_image_mesh`), not a process group
that loses a rank.

:func:`plan_image_mesh` keeps the spatial ``row x col`` grid if the
survivors can carry it (the spatial degree is what the tiles were tuned
for; see ``repro_torch.sharding.halo``) and shrinks ``data`` first; only
when they cannot does it halve the larger spatial axis. :func:`plan_mesh`
is the same arithmetic for the LM meshes ``(pod, data, model)``, whose
``make_mesh`` and ``reshard`` are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

__all__ = [
    "IMAGE_MESH_AXES",
    "ImageMesh",
    "plan_mesh",
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
            "[torch.device('cpu')] * 8) to build an image mesh on the CPU"
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
