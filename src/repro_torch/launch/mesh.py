"""Production mesh construction: the port of ``repro.launch.mesh``.

Defined as functions (no module-level mesh), so importing this module
touches no device.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.runtime.elastic import Mesh, visible_devices

__all__ = ["make_production_mesh", "MESH_SHAPES"]

MESH_SHAPES = {
    "single_pod": ((16, 16), ("data", "model")),
    "multi_pod": ((2, 16, 16), ("pod", "data", "model")),
}


def make_production_mesh(devices: Optional[Sequence] = None, *,
                         multi_pod: bool = False) -> Mesh:
    """16x16 single-pod (256 devices) or 2x16x16 multi-pod (512) mesh over
    ``devices`` (default: every visible CUDA device); with more devices than
    it needs it takes the first ones."""
    shape, axes = MESH_SHAPES["multi_pod" if multi_pod else "single_pod"]
    devices = [torch.device(d) for d in devices] if devices is not None else visible_devices()
    n = math.prod(shape)
    if len(devices) < n:
        raise RuntimeError(f"need {n} devices for mesh {shape}, have {len(devices)}")
    return Mesh(devices[:n], shape, axes)
