"""The edge engine under the ``repro_torch.api`` facade, with backend routing.

Backends:
  * ``cuda``  — K1, the hand-written CUDA kernel (``kernels/csrc/edge.cu``),
                through :func:`repro_torch.kernels.edge.edge_cuda`.
  * ``torch`` — its plain PyTorch version, ``edge_plain``: the counterpart of
                the reference's ``xla`` lane, on any device.
  * ``auto``  — ``cuda`` for a CUDA device, ``torch`` for the CPU.

This slice ports the single-device branch of ``repro.kernels.dispatch.edge``:
one fused launch emits the magnitude (or the components) and the per-tile
maxima; the per-image peak is the max of the tile maxima, and the
normalize epilogue scales by ``255 / max(peak, 1e-8)``. There is no
fallback: a CUDA tensor either goes through the kernel or the call raises.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Tuple

import torch

from repro_torch.core.sobel import magnitude
from repro_torch.kernels import edge as ekern

if TYPE_CHECKING:  # no runtime import: repro_torch.api imports this module
    from repro_torch.api import EdgeConfig, EdgeResult

__all__ = [
    "BACKENDS",
    "resolve_device",
    "resolve_backend",
    "resolve_precision",
    "choose_block_shape",
    "edge",
]

BACKENDS = ("auto", "cuda", "torch")

# EdgeConfig fields whose engine is not ported yet -> their ROADMAP item.
_UNPORTED = (
    ("plan", "queue 1 item 5 (stencil plans)"),
    ("shard", "queue 1 item 10 (multi-GPU halo sharding)"),
    ("nms", "queue 1 item 3 (NMS and hysteresis)"),
    ("hysteresis", "queue 1 item 3 (NMS and hysteresis)"),
    ("temporal", "queue 1 item 8 (streaming)"),
    ("pipeline_depth", "queue 1 item 7 (DMA-ring variant, kernel K2)"),
)


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device. Asking for CUDA where there is none
    raises; nothing moves to the CPU unless the caller asks for it."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch version on the CPU"
        )
    return dev


def resolve_backend(backend: Optional[str], device: torch.device) -> str:
    """Map user intent to a concrete backend for tensors on ``device``."""
    b = backend or "auto"
    if b not in BACKENDS:
        raise ValueError(f"unknown backend {b!r}; expected one of {BACKENDS}")
    if b == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if b == "cuda" and device.type != "cuda":
        raise ValueError(
            f"backend='cuda' launches the CUDA kernel and needs a CUDA device, "
            f"got {device}"
        )
    return b


def resolve_precision(precision: str) -> str:
    """``auto`` and ``f32`` run the f32 lane: on this lane ``auto`` cannot
    choose the integer lane, which the reference proves bit-identical."""
    if precision in ("auto", "f32"):
        return "f32"
    if precision == "int":
        raise NotImplementedError(
            "precision='int' (the exact integer lane) is not ported yet: "
            "ROADMAP queue 1 item 4"
        )
    raise ValueError(
        f"unknown precision {precision!r}; expected 'auto', 'f32' or 'int'"
    )


def choose_block_shape(
    h: int, w: int, *, size: int, block_h: Optional[int] = None,
    block_w: Optional[int] = None,
) -> Tuple[int, int]:
    """Explicit ``block_h``/``block_w`` win field by field; the rest comes
    from ``edge.default_block_shape``."""
    if block_h and block_w:
        return block_h, block_w
    dbh, dbw = ekern.default_block_shape(h, w, size)
    return block_h or dbh, block_w or dbw


def edge(
    images,
    config: "EdgeConfig",
    *,
    layout: Optional[str] = None,
    device=None,
) -> "EdgeResult":
    """Run one :class:`~repro_torch.api.EdgeConfig` end to end on ``device``
    (``None`` = the CUDA device); ``layout`` names the input layout (the
    facade detects it)."""
    from repro_torch.api import EdgeResult, detect_layout

    config = config.resolved()
    for field, item in _UNPORTED:
        if getattr(config, field):
            raise NotImplementedError(
                f"EdgeConfig.{field} is not ported yet: ROADMAP {item}"
            )
    resolve_precision(config.precision)
    dev = resolve_device(device)
    backend = resolve_backend(config.backend, dev)

    images = torch.as_tensor(images)
    layout = layout or detect_layout(tuple(images.shape))
    rgb = layout.endswith("C")
    x = ekern.kernel_dtype(images.to(dev))
    if rgb:
        batch_shape = tuple(x.shape[:-3])
        h, w = x.shape[-3], x.shape[-2]
        x = x.reshape((-1, h, w, 3))
    else:
        batch_shape = tuple(x.shape[:-2])
        h, w = x.shape[-2], x.shape[-1]
        x = x.reshape((-1, h, w))
    x = x.contiguous()

    spec = config.spec
    need_comps = config.with_components or config.with_orientation
    need_peak = config.normalize or config.with_max
    bh, bw = choose_block_shape(h, w, size=spec.size, block_h=config.block_h,
                                block_w=config.block_w)
    run = ekern.edge_cuda if backend == "cuda" else ekern.edge_plain
    out = run(
        x, spec=spec, variant=config.variant, directions=config.directions,
        padding=config.padding, block_h=bh, block_w=bw, rgb=rgb,
        out_components=need_comps, with_max=need_peak,
    )
    primary, bmax = out if need_peak else (out, None)
    comps = None
    if need_comps:
        comps = primary
        mag = magnitude(comps.unbind(dim=1))
    else:
        mag = primary
    peak = bmax.amax(dim=(-2, -1), keepdim=True) if need_peak else None

    orientation = None
    if config.with_orientation:
        orientation = torch.atan2(comps[:, 1], comps[:, 0])

    if config.normalize:
        # torch.full, not torch.tensor: a host-to-device copy of the constant
        # would synchronise the stream behind K1. Tensor / tensor is IEEE
        # division; a Python-scalar divisor would become a reciprocal multiply.
        scale = torch.div(torch.full((), 255.0, dtype=torch.float32, device=dev),
                          peak.clamp_min(1e-8))
        mag = mag * scale

    def unbatch(a, extra_dims=0):
        return a.reshape(batch_shape + tuple(a.shape[a.ndim - 2 - extra_dims:]))

    return EdgeResult(
        magnitude=unbatch(mag),
        components=unbatch(comps, extra_dims=1) if config.with_components else None,
        orientation=unbatch(orientation) if config.with_orientation else None,
        peak=peak.reshape(batch_shape) if config.with_max else None,
        layout=layout,
        config=config,
    )
