"""repro_torch.api — the user-facing facade of the PyTorch/CUDA port.

One call::

    from repro_torch.api import EdgeConfig, edge_detect

    result = edge_detect(frames, EdgeConfig(operator="scharr3"))
    result.magnitude      # (..., H, W) edge image, a tensor on the device
    result.orientation    # present when with_orientation=True
    result.components     # (..., D, H, W) when with_components=True
    result.peak           # (...,) per-image max when with_max=True

    result.thin, result.edges   # with nms=True / hysteresis=True

    # streaming: one frame per stream per call, state carried between calls
    cfg = EdgeConfig(temporal=True, decay=0.9)
    result, state = edge_detect_stream(frame, cfg)              # cold start
    result, state = edge_detect_stream(next_frame, cfg, state)
    result.skipped        # delta-skipped tiles per stream

``edge_detect`` and ``edge_detect_stream`` run on the CUDA device unless
``device`` says otherwise; ``device="cpu"`` runs the plain PyTorch version.
:class:`EdgeConfig` has the reference's fields and defaults
(``repro.api.EdgeConfig``). ``shard`` spreads a call over an image mesh
(batch groups and a spatial grid with halo exchange, bit-exact with one
device)::

    result = edge_detect(frames, EdgeConfig(shard=ShardConfig(2, 2, 2)))
    mesh = make_image_mesh([torch.device("cuda:0")] * 8, rows=2, cols=2)
    result = edge_detect(frames, mesh=mesh)      # a mesh overrides shard

A stencil plan runs as one fused launch::

    result = edge_detect(frames, EdgeConfig(plan="canny5", hysteresis=True))

With no explicit tile, the tuning cache (``REPRO_TUNE_CACHE``,
``repro_torch.kernels.tuning``) picks the tile and ring depth.

Input layout is auto-detected (``HW`` / ``HWC`` / ``NHW`` / ``NHWC`` /
``NTHW`` / ``NTHWC``): a trailing dimension of exactly 3 on a >= 3-D input
is the RGB channel axis; everything before ``(H, W)`` is batch. Pass
``layout=`` to override.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.filters import OperatorSpec, SobelParams, get_operator, resolve_plan
from repro_torch.core.nms import DEFAULT_HIGH, DEFAULT_LOW
from repro_torch.sharding.halo import ShardConfig

__all__ = [
    "EdgeConfig",
    "EdgeResult",
    "ShardConfig",
    "StreamState",
    "edge_detect",
    "edge_detect_stream",
    "detect_layout",
    "LAYOUTS",
]

LAYOUTS = ("HW", "HWC", "NHW", "NHWC", "NTHW", "NTHWC")


def detect_layout(shape: Tuple[int, ...]) -> str:
    """Canonical layout string for an input shape.

    A trailing dim of exactly 3 on a >= 3-D input is the RGB channel axis;
    the last two remaining dims are ``(H, W)``; every leading dim is batch.
    """
    ndim = len(shape)
    rgb = ndim >= 3 and shape[-1] == 3
    spatial = ndim - (1 if rgb else 0)
    if spatial < 2:
        raise ValueError(f"cannot interpret shape {shape} as image(s)")
    batch = spatial - 2
    prefix = ("", "N", "NT")[batch] if batch <= 2 else "N" * batch
    return prefix + "HW" + ("C" if rgb else "")


@dataclasses.dataclass(frozen=True)
class EdgeConfig:
    """Everything one edge-detection call needs, in one frozen value.

    The fields and defaults of ``repro.api.EdgeConfig``:
      operator:   registered operator name (``sobel5`` | ``sobel3`` |
                  ``scharr3`` | ``prewitt3`` | ``sobel7`` | custom).
      plan:       multi-stage stencil plan: a registered plan name
                  (``canny5`` | ``blur_sobel5``) or a
                  :class:`~repro_torch.core.filters.StencilPlan`. It
                  overrides ``operator`` (the resolved config pins it to
                  the plan's gradient stage), composes the halo from every
                  stage radius and, when it ends in an ``nms`` stage,
                  forces ``nms=True``. The chain runs as one K1 or K2
                  launch on ``cuda``.
      directions: direction count; 0 = the operator's maximum.
      variant:    ``direct``/``separable``/``v1``/``v2``; ``auto`` = the
                  operator's best. Unsupported ladder variants coerce down.
      params:     custom generalized weights (Sobel-5x5 family).
      padding:    boundary rule: ``reflect`` | ``edge`` | ``zero``.
      normalize:  scale the magnitude into [0, 255] per image.
      backend:    ``auto`` | ``cuda`` | ``torch``; None = auto (``cuda`` on
                  a CUDA device, ``torch`` on the CPU).
      block_h/block_w: CTA output tile override; None = the tuning cache's
                  tile, else the default.
      precision:  arithmetic lane: ``auto`` | ``f32`` | ``int``. ``int`` is
                  the exact integer lane: u8 gray frames x integer taps
                  accumulate in int32 on the card (the i16/i32 dtype
                  ``core/ladder.py`` licenses in the plain lane), f32 only
                  at the magnitude and NMS, bit-identical to ``f32``; it
                  raises naming the failing gate on RGB, float frames or
                  fractional taps. ``auto`` takes it for eligible frames on
                  the ``cuda`` backend and stays f32 on ``torch``
                  (``kernels.dispatch.resolve_precision``).
      pipeline_depth: None = the tuned depth, else 0 (kernel K1); 2..8 runs
                  kernel K2, a ring of that many input windows copied ahead
                  of the compute (bit-identical to K1; raises when the ring
                  does not fit the tile's shared memory).
      shard:      a :class:`~repro_torch.sharding.halo.ShardConfig`: spread
                  the call over the image mesh of every visible CUDA device
                  (``data`` batch groups x a ``rows x cols`` spatial grid
                  with halo exchange); None = one device. ``device="cpu"``
                  gives a mesh of the one CPU device; pass ``mesh=`` to
                  :func:`edge_detect` for any other device list.
      nms:        thin the magnitude by non-maximum suppression (in K1).
      hysteresis: link the thin map into a bool edge map (implies nms).
      low/high:   hysteresis thresholds as fractions of the peak.
      temporal, decay: temporal hysteresis on the stream path
                  (:func:`edge_detect_stream` only).
      with_components:  also return per-direction gradients ``(..., D, H, W)``.
      with_orientation: also return ``atan2(G_y, G_x)``.
      with_max:         also return the per-image peak of the unnormalized
                        magnitude.
    """

    operator: str = "sobel5"
    plan: Any = None
    directions: int = 0
    variant: str = "auto"
    params: Optional[SobelParams] = None
    padding: str = "reflect"
    normalize: bool = True
    backend: Optional[str] = None
    block_h: Optional[int] = None
    block_w: Optional[int] = None
    precision: str = "auto"
    pipeline_depth: Optional[int] = None
    shard: Optional[ShardConfig] = None
    nms: bool = False
    hysteresis: bool = False
    low: Optional[float] = None
    high: Optional[float] = None
    temporal: bool = False
    decay: float = 0.0
    with_components: bool = False
    with_orientation: bool = False
    with_max: bool = False

    def replace(self, **kw) -> "EdgeConfig":
        return dataclasses.replace(self, **kw)

    def resolved(self) -> "EdgeConfig":
        """Fill ``auto``/0 fields from the operator spec and validate, as
        ``repro.api.EdgeConfig.resolved`` does. Idempotent."""
        if self.precision not in ("auto", "f32", "int"):
            raise ValueError(
                f"unknown precision {self.precision!r}; expected 'auto', "
                "'f32' or 'int'"
            )
        if self.pipeline_depth is not None and not (
            isinstance(self.pipeline_depth, int)
            and 2 <= self.pipeline_depth <= 8
        ):
            raise ValueError(
                f"pipeline_depth must be None (automatic) or an int in "
                f"2..8 (manual DMA ring depth), got {self.pipeline_depth!r}"
            )
        if not 0.0 <= self.decay <= 1.0:
            raise ValueError(
                f"decay={self.decay} must be a per-frame attenuation in [0, 1]"
            )
        if self.decay and not self.temporal:
            raise ValueError(
                "decay is the temporal-hysteresis attenuation; set "
                "temporal=True or leave it 0"
            )
        if self.padding not in ("reflect", "edge", "zero"):
            raise ValueError(
                f"unknown padding {self.padding!r}; expected reflect | edge | zero"
            )
        hysteresis = self.hysteresis or self.temporal
        low, high = self.low, self.high
        if not hysteresis and (low is not None or high is not None):
            if (low, high) == (DEFAULT_LOW, DEFAULT_HIGH):
                low = high = None
            else:
                raise ValueError(
                    "low/high are hysteresis thresholds; set hysteresis=True "
                    "or leave them unset"
                )
        if hysteresis:
            low = DEFAULT_LOW if low is None else low
            high = DEFAULT_HIGH if high is None else high
        for name, v in (("low", low), ("high", high)):
            if v is not None and not 0.0 <= v <= 1.0:
                raise ValueError(
                    f"{name}={v} must be a fraction of the magnitude peak in [0, 1]"
                )
        if low is not None and high is not None and low > high:
            raise ValueError(f"low={low} must not exceed high={high}")
        plan = resolve_plan(self.plan)
        if plan is not None:
            spec = plan.gradient
            if spec is None:
                raise ValueError(
                    f"plan {plan.name!r} has no gradient stage; the edge "
                    "engine emits direction components (append a gradient "
                    "operator stage)"
                )
            if (self.nms or hysteresis) and not plan.nms:
                raise ValueError(
                    f"plan gate 'nms-stage': plan {plan.name!r} has no "
                    "trailing 'nms' stage but nms/hysteresis was requested; "
                    "the plan is the single source of truth — append 'nms' "
                    "to its stages"
                )
            operator = spec.name
            nms = plan.nms or hysteresis
        else:
            spec = get_operator(self.operator, self.params)
            operator = self.operator
            nms = self.nms or hysteresis
        return self.replace(
            plan=plan,
            operator=operator,
            directions=spec.resolve_directions(self.directions),
            variant=spec.resolve_variant(self.variant),
            nms=nms,
            hysteresis=hysteresis,
            low=low,
            high=high,
        )

    @property
    def spec(self) -> OperatorSpec:
        plan = resolve_plan(self.plan)
        if plan is not None and plan.gradient is not None:
            return plan.gradient
        return get_operator(self.operator, self.params)


@dataclasses.dataclass(frozen=True)
class EdgeResult:
    """Structured output of :func:`edge_detect` (tensors on the device).

    ``magnitude`` is always present; the optional fields mirror the
    ``with_*`` output selection of :class:`EdgeConfig`. ``thin`` is the NMS
    thin map (``nms``; the same tensor as ``magnitude``, normalized when
    ``normalize``), ``edges`` the bool hysteresis map (``hysteresis``) and
    ``skipped`` the per-stream count of delta-skipped tiles (stream path).
    ``layout`` is the detected (or overridden) input layout; ``config`` the
    resolved config that produced the result.
    """

    magnitude: torch.Tensor                     # (..., H, W) f32
    components: Optional[torch.Tensor] = None   # (..., D, H, W) f32
    orientation: Optional[torch.Tensor] = None  # (..., H, W) f32, radians
    peak: Optional[torch.Tensor] = None         # (...,) f32 per-image max
    thin: Optional[torch.Tensor] = None         # (..., H, W) f32, nms=True
    edges: Optional[torch.Tensor] = None        # (..., H, W) bool, hysteresis
    skipped: Optional[torch.Tensor] = None      # (...,) i32 delta-skipped tiles
    layout: str = "HW"
    config: Optional[EdgeConfig] = None


@dataclasses.dataclass(frozen=True)
class StreamState:
    """Per-stream state carried between the frames of one video stream.

    Tensors on the stream's device, batched ``(B, ...)``, one slice per
    stream when the engine batches same-resolution streams:

      * ``frame``   — the previous input frames in kernel dtype (u8 stays
        u8), the reference of the exact per-tile change test.
      * ``primary`` — the previous un-normalized primary map (the thin map
        with ``nms``, else the magnitude), the splice source of skipped
        tiles.
      * ``bmax``    — the previous per-tile maxima ``(B, gh, gw)`` of the
        un-thinned magnitude, spliced per tile so the peak stays exact.
      * ``seed``    — the temporal seed strength (``config.temporal``;
        ``None`` otherwise).

    ``block`` pins the ``(block_h, block_w)`` tile grid for every frame of
    the stream. ``initialized`` is False for the zero state :meth:`init`
    returns; the first frame then recomputes every tile.
    """

    frame: Optional[torch.Tensor]
    primary: Optional[torch.Tensor]
    bmax: Optional[torch.Tensor]
    seed: Optional[torch.Tensor]
    block: Tuple[int, int] = (0, 0)
    initialized: bool = False

    @property
    def grid(self) -> Tuple[int, int]:
        """(gh, gw) tile grid of the cached ``bmax``."""
        return self.bmax.shape[-2], self.bmax.shape[-1]

    @property
    def tiles(self) -> int:
        """Tiles per frame (the denominator of skip rates)."""
        gh, gw = self.grid
        return gh * gw

    def map(self, fn) -> "StreamState":
        """The state with ``fn`` applied to each tensor leaf."""
        return dataclasses.replace(
            self, **{f: None if getattr(self, f) is None else fn(getattr(self, f))
                     for f in ("frame", "primary", "bmax", "seed")})

    @staticmethod
    def concat(states) -> "StreamState":
        """Concatenate states along the batch (one batched call)."""
        first = states[0]
        return dataclasses.replace(
            first, **{f: None if getattr(first, f) is None
                      else torch.cat([getattr(s, f) for s in states], dim=0)
                      for f in ("frame", "primary", "bmax", "seed")})

    @classmethod
    def init(cls, batch, h, w, config: "EdgeConfig", *, rgb: bool = False,
             dtype=torch.uint8, device=None) -> "StreamState":
        """Zero state for ``batch`` streams of ``(h, w)`` frames on
        ``device`` (``None`` = the CUDA device). The first frame on it
        recomputes every tile and fills the caches."""
        from repro_torch.kernels import dispatch

        dev = dispatch.resolve_device(device)
        config = config.resolved()
        bh, bw = dispatch.stream_block_shape(
            h, w, config, backend=dispatch.resolve_backend(config.backend, dev), rgb=rgb,
            dtype="uint8" if dtype == torch.uint8 else "float32")
        gh, gw = -(-h // bh), -(-w // bw)
        shape = (batch, h, w, 3) if rgb else (batch, h, w)
        return cls(
            frame=torch.zeros(shape, dtype=dtype, device=dev),
            primary=torch.zeros((batch, h, w), dtype=torch.float32, device=dev),
            bmax=torch.zeros((batch, gh, gw), dtype=torch.float32, device=dev),
            seed=(torch.zeros((batch, h, w), dtype=torch.float32, device=dev)
                  if config.temporal else None),
            block=(bh, bw),
            initialized=False,
        )


def edge_detect(
    images,
    config: Optional[EdgeConfig] = None,
    *,
    layout: Optional[str] = None,
    device=None,
    mesh=None,
    **overrides,
) -> EdgeResult:
    """Run the edge-detection pipeline on ``images``.

    Args:
      images: numpy array or tensor, ``HW`` / ``HWC`` / ``NHW`` / ``NHWC`` /
        ``NTHW`` / ``NTHWC``; u8 or float.
      config: an :class:`EdgeConfig`; None = defaults.
      layout: explicit layout override (skips auto-detection).
      device: where to run; None = the CUDA device (raises when there is
        none). ``"cpu"`` runs the plain PyTorch version.
      mesh: an image mesh (``repro_torch.runtime.elastic.ImageMesh``)
        overriding ``config.shard``, for callers that manage the device
        population themselves (elastic serving). Results gather on its
        first device.
      **overrides: field overrides applied to ``config``.

    Returns:
      :class:`EdgeResult` with batch dims mirroring the input's.
    """
    from repro_torch.kernels import dispatch

    cfg = config or EdgeConfig()
    if overrides:
        cfg = cfg.replace(**overrides)
    return dispatch.edge(images, cfg.resolved(), layout=layout, device=device, mesh=mesh)


def edge_detect_stream(
    frames,
    config: Optional[EdgeConfig] = None,
    state: Optional[StreamState] = None,
    *,
    layout: Optional[str] = None,
    device=None,
    **overrides,
) -> Tuple[EdgeResult, StreamState]:
    """One frame step of the stateful streaming pipeline.

    ``frames`` is one frame per stream: ``HW`` / ``HWC`` for one stream or
    ``NHW`` / ``NHWC`` for a batch of same-resolution streams (time is the
    successive calls). ``state`` is the previous call's
    :class:`StreamState` (``None`` = cold start). ``device`` as for
    :func:`edge_detect`.

    Returns ``(result, new_state)``. On top of the stateless pipeline:

      * **Delta-skip tiles**: an exact per-tile change test against
        ``state.frame``; unchanged tiles splice the cached primary map and
        tile maxima instead of recomputing (``result.skipped`` counts
        them). The output equals a full recompute bit for bit.
      * **Temporal hysteresis**: with ``config.temporal``, recent frames'
        edges seed this frame's linking, decayed by ``config.decay``.
        ``decay=0`` equals stateless :func:`edge_detect` bit for bit.

    ``repro_torch.serve.streams.StreamEngine`` drives it for many
    concurrent streams.
    """
    from repro_torch.kernels import dispatch

    cfg = config or EdgeConfig()
    if overrides:
        cfg = cfg.replace(**overrides)
    return dispatch.edge_stream(frames, cfg.resolved(), state, layout=layout, device=device)
