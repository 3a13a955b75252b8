"""Edge-detection pipeline pieces: the colour conversion and the sharded
detector over an image mesh."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.tiling import luma

__all__ = ["rgb_to_gray", "make_sharded_edge_fn"]


def rgb_to_gray(images: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8/float -> (..., H, W) float32 BT.601 grayscale,
    rounded exactly as the CUDA kernel computes it per pixel."""
    return luma(images)


def make_sharded_edge_fn(
    mesh,
    config=None,
    *,
    batch_axes=("data",),
    row_axis: Optional[str] = "row",
    **config_overrides,
):
    """Edge detector with the batch spread over ``batch_axes`` and image rows
    over ``row_axis`` of an image mesh (``runtime.elastic.ImageMesh``) or of
    an LM mesh (``runtime.elastic.make_mesh``: pass ``row_axis="model"``,
    the reference's default, to band the rows over its ``model`` axis).

    The port of ``repro.core.pipeline.make_sharded_edge_fn``. The reference
    lets GSPMD insert the row halo over a JAX mesh; here the call runs the
    halo-exchange engine (``sharding.halo``) on the sub-mesh of ``data``
    groups (when ``"data"`` is in ``batch_axes``) x ``row`` bands, with no
    column bands, as in the reference. The image mesh names its row axis
    ``row``, so that is the default; an axis the mesh lacks is dropped.
    Nothing is compiled: PyTorch runs eagerly.

    ``config`` is an :class:`~repro_torch.api.EdgeConfig` (default: an
    unnormalized Sobel-5x5 pass); ``config_overrides`` are field overrides,
    including the legacy ``size=`` selector. Returns ``fn(images: (N, H, W)
    or (N, H, W, 3)) -> (N, H, W)`` magnitude on the mesh's first device.
    """
    from repro_torch.api import EdgeConfig, edge_detect
    from repro_torch.core.filters import operator_for_size
    from repro_torch.runtime.elastic import make_image_mesh

    size = config_overrides.pop("size", None)
    cfg = config or EdgeConfig(normalize=False)
    if size is not None:
        cfg = cfg.replace(operator=operator_for_size(size))
    if config_overrides:
        cfg = cfg.replace(**config_overrides)
    cfg = cfg.resolved()

    data = mesh.shape["data"] if "data" in batch_axes else 1
    rows = mesh.shape[row_axis] if row_axis in mesh.axis_names else 1
    sub = make_image_mesh(mesh.flat(), rows=rows, cols=1, data=data)

    def fn(images):
        return edge_detect(images, cfg, mesh=sub).magnitude

    return fn
