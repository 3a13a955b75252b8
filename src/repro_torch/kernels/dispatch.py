"""The edge engine under the ``repro_torch.api`` facade, with backend routing.

Backends:
  * ``cuda``  — the hand-written CUDA kernels: K1 (``kernels/csrc/edge.cu``)
                through :func:`repro_torch.kernels.edge.edge_cuda`, K2 (the
                DMA ring, ``kernels/csrc/edge_pipelined.cu``) for a ring
                depth of 2..8, and on the stream path K3
                (``kernels/csrc/edge_stream.cu``) through
                ``edge_stream_cuda``.
  * ``torch`` — their plain PyTorch versions, ``edge_plain`` and
                ``edge_stream_plain``: the counterpart of the reference's
                ``xla`` lane, on any device.
  * ``auto``  — ``cuda`` for a CUDA device, ``torch`` for the CPU.

:func:`edge` ports ``repro.kernels.dispatch.edge``. Single-device:
:func:`resolve_precision` picks the lane (the exact integer lane for
eligible u8 gray frames on ``cuda``), :func:`choose_block_shape` the tile
and ring depth (explicit config fields, then the tuning cache
``kernels/tuning.py``, then the default), and one fused launch emits the
magnitude (or the components, or with ``nms`` the thin map) and the
per-tile maxima of the un-thinned magnitude; the
per-image peak is the max of the tile maxima; hysteresis links the
assembled thin map (a global fixpoint, so never inside the kernel); the
normalize epilogue scales by ``255 / max(peak, 1e-8)``. A stencil plan
(``EdgeConfig.plan``) takes the same funnel: the lane through
``core.ladder.plan_int_eligible``, the tile from the plan's own cache slot
(``filters.plan_identity``) or a default sized by its composed reach, and
one K1 or K2 launch that runs its pre-stages ahead of the gradient; the
stream path refuses plans with pre-stages, as the reference does. With a
mesh of more than one device (``mesh=``, or ``EdgeConfig.shard``) the
sharded branch runs the same kernels once per shard, on the halo-extended
block (``sharding/halo.py``), and takes the peak over each shard's valid
pixels; hysteresis and the normalize epilogue run on the gathered maps.

:func:`edge_stream` is one frame step of the streaming detector: a per-tile
change test against the previous frame (:func:`stream_delta`), one K3
launch that recomputes the changed tiles and splices the cached ones, then
the epilogue (peak, plain or temporal hysteresis, normalize).
:func:`edge_stream_cached` serves a frame in which nothing changed from the
caches alone. There is no fallback: a CUDA tensor either goes through the
kernels or the call raises.
"""
from __future__ import annotations

import warnings
from typing import TYPE_CHECKING, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import ladder
from repro_torch.core import nms as core_nms
from repro_torch.core.filters import get_operator, plan_identity
from repro_torch.core.sobel import magnitude
from repro_torch.kernels import edge as ekern
from repro_torch.kernels import tuning
from repro_torch.kernels.tiling import ALIGN_INTERPRET, window_radius, window_shape

if TYPE_CHECKING:  # no runtime import: repro_torch.api imports this module
    from repro_torch.api import EdgeConfig, EdgeResult, StreamState

__all__ = [
    "BACKENDS",
    "resolve_device",
    "resolve_backend",
    "refuse_detached",
    "resolve_precision",
    "choose_block_shape",
    "stream_block_shape",
    "edge",
    "stream_delta",
    "edge_stream",
    "edge_stream_cached",
]

BACKENDS = ("auto", "cuda", "torch")

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


def refuse_detached(name: str, instead: str, *inputs: torch.Tensor) -> None:
    """Raise where a kernel's output would cut the autograd graph: grad
    mode on and an input that requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{name}(backend='cuda') under autograd: the kernel's output carries no gradient, "
            f"so every parameter upstream would silently get none; call {instead} (its "
            "autograd Function), or run under torch.no_grad()")


def resolve_precision(precision: str, backend: str, *, spec, rgb: bool, input_dtype,
                      plan=None) -> str:
    """Resolve ``EdgeConfig.precision`` to the lane that runs: f32 | int.

    The reference's table, with ``cuda`` for ``pallas-tpu`` and ``torch``
    for ``xla``: explicit ``"int"`` runs on either backend but raises, with
    the first failing gate of ``core.ladder.int_lane_eligible`` (with a
    ``plan``, of the ``plan_int_eligible`` chain), when the exactness proof
    does not cover the workload (fractional taps, RGB input, non-u8
    frames); ``"auto"`` takes the integer lane for eligible workloads on
    ``cuda`` only and stays f32 on ``torch``. ``input_dtype`` is the dtype
    the kernel sees.
    """
    def eligible():
        if plan is not None:
            return ladder.plan_int_eligible(plan, rgb=rgb, input_dtype=input_dtype)
        return ladder.int_lane_eligible(spec, rgb=rgb, input_dtype=input_dtype)

    if precision == "f32":
        return "f32"
    if precision == "int":
        ok, reason = eligible()
        if not ok:
            raise ValueError(f"precision='int' unavailable: {reason}")
        return "int"
    if precision != "auto":
        raise ValueError(
            f"unknown precision {precision!r}; expected 'auto', 'f32' or 'int'"
        )
    if backend == "torch":
        return "f32"
    ok, _reason = eligible()
    return "int" if ok else "f32"


def choose_block_shape(
    h: int,
    w: int,
    *,
    operator: str = "sobel5",
    variant: str = "v2",
    dtype: str = "float32",
    backend: str = "torch",
    padding: str = "reflect",
    layout: str = "gray",
    block_h: Optional[int] = None,
    block_w: Optional[int] = None,
    cache: Optional[tuning.TuningCache] = None,
    devices: int = 1,
    mesh: str = "1x1x1",
    kernel_h: Optional[int] = None,
    kernel_w: Optional[int] = None,
    precision: str = "f32",
    pipeline_depth: Optional[int] = None,
    nms: bool = False,
    plan=None,
) -> Tuple[int, int, int, str]:
    """Resolve ``(block_h, block_w, depth, source)`` as the reference does.

    ``source`` is ``"explicit"`` (both tile fields given), ``"tuned"`` (a
    hit in the tuning cache, ``kernels.tuning``) or ``"default"``
    (``edge.default_block_shape``). The cache key carries the resolved
    ``precision`` and the requested depth: an explicit ``pipeline_depth``
    pins the returned depth and looks up its own slot; ``None`` looks up
    slot 0 and lets a tuned entry supply the depth its sweep measured
    faster, else 0 (K1). One explicit tile field overrides that field of a
    tuned or default tile.

    The key carries no ``nms``, so on ``cuda`` a tuned tile whose
    footprint for this call (``nms``, the depth and the plan) exceeds
    ``SMEM_MAX`` is skipped with a warning, like a corrupt entry: a cache
    entry never turns a call that works into an error.

    ``plan`` (a resolved stencil plan) keys its own slot,
    ``filters.plan_identity(plan)`` in place of ``-``, and sizes the
    default tile by its composed reach (``2 * plan.linear_reach + 1``).

    ``h``/``w`` key the cache on the frame the user sees. A sharded call
    fills ``devices`` and ``mesh`` (``"DxRxC"``), so its tunings do not
    collide with single-device ones, and names the halo-extended block each
    shard's kernel tiles in ``kernel_h``/``kernel_w``, which size the
    default tile.
    """
    if block_h and block_w:
        return block_h, block_w, pipeline_depth or 0, "explicit"
    cache = cache if cache is not None else tuning.get_default_cache()
    spec = plan.gradient if plan is not None else get_operator(operator)
    key = tuning.TuneKey(backend, dtype, operator, variant, h, w, padding, layout, devices, mesh,
                         precision, pipeline_depth or 0,
                         plan_identity(plan) if plan is not None else "-")
    hit = cache.lookup(key)
    if hit is not None:
        bh, bw, depth = hit
        if pipeline_depth is not None:
            depth = pipeline_depth
        bh, bw = block_h or bh, block_w or bw
        smem = tuning.tile_smem_bytes(bh, bw, spec, depth=depth, layout=layout, dtype=dtype,
                                      nms=nms, plan=plan)
        if backend != "cuda" or smem <= ekern.SMEM_MAX:
            return bh, bw, depth, "tuned"
        warnings.warn(
            f"skipping tuned tile {bh}x{bw} depth {depth} of {key.to_str()!r}: with "
            f"nms={nms} it needs {smem} B of shared memory, above {ekern.SMEM_MAX} B",
            RuntimeWarning, stacklevel=2,
        )
    size = 2 * plan.linear_reach + 1 if plan is not None else spec.size
    dbh, dbw = ekern.default_block_shape(kernel_h or h, kernel_w or w, size)
    return block_h or dbh, block_w or dbw, pipeline_depth or 0, "default"


def _kernel_dtype_name(x: torch.Tensor) -> str:
    """The input dtype the kernel sees (``edge.kernel_dtype``), as the
    tuning cache names it."""
    return "uint8" if x.dtype == torch.uint8 else "float32"


def _flatten(images, layout: Optional[str], dev: torch.device):
    """``images`` on ``dev`` in kernel dtype, as a contiguous ``(B, H, W[,
    3])`` batch; returns ``(x, layout, rgb, batch_shape, h, w)``."""
    from repro_torch.api import detect_layout

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
    return x.contiguous(), layout, rgb, batch_shape, h, w


def _normalize(mag: torch.Tensor, peak: torch.Tensor) -> torch.Tensor:
    """``mag * (255 / max(peak, 1e-8))`` with the reference's roundings.

    torch.full, not torch.tensor: a host-to-device copy of the constant would
    synchronise the stream behind the kernel. Tensor / tensor is IEEE
    division; a Python-scalar divisor would become a reciprocal multiply.
    """
    scale = torch.div(torch.full((), 255.0, dtype=torch.float32, device=mag.device),
                      peak.clamp_min(1e-8))
    return mag * scale


def _edge_single(x, config, backend, *, rgb, h, w, need_comps, need_peak, tuning_cache,
                 precision):
    """The single-device branch of :func:`edge`: one fused launch that also
    emits the per-tile maxima of the un-thinned magnitude; the peak is their
    max. Returns ``(primary, comps | None, peak (B, 1, 1) | None)``."""
    bh, bw, depth, _source = choose_block_shape(
        h, w, operator=config.operator, variant=config.variant,
        dtype=_kernel_dtype_name(x), backend=backend, padding=config.padding,
        layout="rgb" if rgb else "gray", block_h=config.block_h, block_w=config.block_w,
        cache=tuning_cache, precision=precision, pipeline_depth=config.pipeline_depth,
        nms=config.nms, plan=config.plan,
    )
    run = ekern.edge_cuda if backend == "cuda" else ekern.edge_plain
    out = run(
        x, spec=config.spec, variant=config.variant, directions=config.directions,
        padding=config.padding, block_h=bh, block_w=bw, rgb=rgb,
        out_components=need_comps, out_nms=config.nms, with_max=need_peak,
        precision=precision, pipeline_depth=depth, plan=config.plan,
    )
    outs = list(out) if isinstance(out, tuple) else [out]
    bmax = outs.pop() if need_peak else None
    comps = None
    if config.nms:
        mag = outs.pop(0)  # the thin map
        comps = outs.pop(0) if need_comps else None
    elif need_comps:
        comps = outs.pop(0)
        mag = magnitude(comps.unbind(dim=1))
    else:
        mag = outs.pop(0)
    peak = bmax.amax(dim=(-2, -1), keepdim=True) if need_peak else None
    return mag, comps, peak


def _shard_compute(config: "EdgeConfig", backend: str, *, rgb: bool, need_comps: bool,
                   need_raw: bool, block_h: int, block_w: int, precision: str, depth: int):
    """The per-shard engine: ``(B, h, w[, 3]) -> (primary, components |
    None, raw magnitude | None)`` through the single-device kernels (K1, or
    K2 at a ring depth, on ``cuda``; ``edge_plain`` on ``torch``).

    ``primary`` is the magnitude, or with ``config.nms`` the thin map;
    ``need_raw`` adds the un-thinned magnitude in NMS mode, the peak's
    source. No tile maxima: a shard's peak is taken over its valid pixels
    only (``sharding.halo.sharded_edge``)."""
    run = ekern.edge_cuda if backend == "cuda" else ekern.edge_plain
    kw = dict(spec=config.spec, variant=config.variant, directions=config.directions,
              padding=config.padding, block_h=block_h, block_w=block_w, rgb=rgb,
              precision=precision, pipeline_depth=depth, plan=config.plan)

    def compute(xl):
        if config.nms:
            out = run(xl, out_nms=True, out_components=need_comps, out_mag=need_raw, **kw)
            outs = list(out) if isinstance(out, tuple) else [out]
            thin = outs.pop(0)
            comps = outs.pop(0) if need_comps else None
            return thin, comps, (outs.pop(0) if need_raw else None)
        if need_comps:
            comps = run(xl, out_components=True, **kw)
            return magnitude(comps.unbind(dim=1)), comps, None
        return run(xl, **kw), None, None

    return compute


def _edge_sharded(x, config, backend, mesh, *, rgb, h, w, need_comps, need_peak,
                  tuning_cache, precision, chaos=None):
    """The sharded branch of :func:`edge`: ``(primary, comps | None, peak
    (B, 1, 1) | None)``, bit-exact with the single-device branch.

    The halo is ``halo.exchange_radius``: the operator's radius, the plan's
    composed reach, plus one with NMS (hysteresis, a global fixpoint, runs
    on the gathered map). The tile is chosen for the halo-extended block
    each shard's kernel sees, under the mesh's own tuning slot."""
    from repro_torch.sharding import halo

    r = halo.exchange_radius(config.spec, config.nms, plan=config.plan)
    d, rr, cc = mesh.shape["data"], mesh.shape["row"], mesh.shape["col"]
    sh, _hp = halo.shard_geometry(h, rr, r)
    sw, _wp = halo.shard_geometry(w, cc, r)
    bh, bw, depth, _source = choose_block_shape(
        h, w, operator=config.operator, variant=config.variant,
        dtype=_kernel_dtype_name(x), backend=backend, padding=config.padding,
        layout="rgb" if rgb else "gray", block_h=config.block_h, block_w=config.block_w,
        cache=tuning_cache, devices=d * rr * cc, mesh=f"{d}x{rr}x{cc}",
        kernel_h=sh + (2 * r if rr > 1 else 0), kernel_w=sw + (2 * r if cc > 1 else 0),
        precision=precision, pipeline_depth=config.pipeline_depth, nms=config.nms,
        plan=config.plan,
    )
    compute = _shard_compute(config, backend, rgb=rgb, need_comps=need_comps,
                             need_raw=config.nms and need_peak, block_h=bh, block_w=bw,
                             precision=precision, depth=depth)
    mag, comps, peak = halo.sharded_edge(
        x, mesh, radius=r, padding=config.padding, compute=compute, rgb=rgb,
        need_comps=need_comps, need_peak=need_peak, chaos=chaos,
    )
    return mag, comps, (peak[:, None, None] if need_peak else None)


def _mesh_device(config: "EdgeConfig", mesh, device):
    """``(mesh or None, device)`` for a call: ``mesh`` overrides
    ``config.shard``; a shard config alone builds its mesh over every
    visible CUDA device, or over ``device`` itself when that is the CPU.
    With a mesh the frames land on, and the results gather on, its first
    device; ``device``, if given, must be of the same type."""
    if mesh is None and config.shard is not None:
        from repro_torch.sharding import halo

        dev = resolve_device(device)
        mesh = halo.mesh_from_config(config.shard, [dev] if dev.type == "cpu" else None)
    if mesh is None:
        return None, resolve_device(device)
    kinds = {dv.type for dv in mesh.flat()}
    if device is not None:
        kinds.add(torch.device(device).type)
    if len(kinds) > 1:
        raise ValueError(f"the mesh's devices and device={device!r} mix device types {kinds}")
    return mesh, resolve_device(mesh.lead)


def edge(
    images,
    config: "EdgeConfig",
    *,
    layout: Optional[str] = None,
    device=None,
    tuning_cache: Optional[tuning.TuningCache] = None,
    mesh=None,
    chaos=None,
) -> "EdgeResult":
    """Run one :class:`~repro_torch.api.EdgeConfig` end to end on ``device``
    (``None`` = the CUDA device); ``layout`` names the input layout (the
    facade detects it); ``tuning_cache`` replaces the process-wide cache.

    ``mesh`` (a ``runtime.elastic.ImageMesh``) overrides ``config.shard``:
    the image server passes the survivors' mesh after an elastic replan. A
    mesh of more than one device runs the sharded engine
    (``sharding.halo``), bit-exact with the single-device branch. ``chaos``
    (a ``runtime.chaos.FaultPlan``) fires the ``"dispatch.edge"`` site on
    entry."""
    from repro_torch.api import EdgeResult

    if chaos is not None:
        chaos.fire("dispatch.edge")
    config = config.resolved()
    if config.temporal:
        raise ValueError(
            "temporal hysteresis carries per-stream state; use "
            "repro_torch.api.edge_detect_stream (or drop temporal for stateless "
            "calls)"
        )
    mesh, dev = _mesh_device(config, mesh, device)
    backend = resolve_backend(config.backend, dev)
    x, layout, rgb, batch_shape, h, w = _flatten(images, layout, dev)

    spec = config.spec
    need_comps = config.with_components or config.with_orientation
    # Hysteresis thresholds are fractions of the per-image magnitude peak.
    need_peak = config.normalize or config.with_max or config.hysteresis
    # The lane is resolved once, against the dtype the kernel sees.
    precision = resolve_precision(config.precision, backend, spec=spec, rgb=rgb,
                                  input_dtype=x.dtype, plan=config.plan)
    if mesh is not None and mesh.size > 1:
        mag, comps, peak = _edge_sharded(
            x, config, backend, mesh, rgb=rgb, h=h, w=w, need_comps=need_comps,
            need_peak=need_peak, tuning_cache=tuning_cache, precision=precision, chaos=chaos,
        )
    else:
        mag, comps, peak = _edge_single(x, config, backend, rgb=rgb, h=h, w=w,
                                        need_comps=need_comps, need_peak=need_peak,
                                        tuning_cache=tuning_cache, precision=precision)

    orientation = None
    if config.with_orientation:
        orientation = torch.atan2(comps[:, 1], comps[:, 0])

    edges = None
    if config.hysteresis:
        # On the assembled thin map: linking is a global fixpoint. The
        # thresholds scale with the un-thinned peak and apply to the
        # un-normalized thin map.
        low, high = core_nms.resolve_thresholds(peak, config.low, config.high)
        edges = core_nms.hysteresis(mag, low, high)

    if config.normalize:
        mag = _normalize(mag, peak)

    def unbatch(a, extra_dims=0):
        return a.reshape(batch_shape + tuple(a.shape[a.ndim - 2 - extra_dims:]))

    return EdgeResult(
        magnitude=unbatch(mag),
        components=unbatch(comps, extra_dims=1) if config.with_components else None,
        orientation=unbatch(orientation) if config.with_orientation else None,
        peak=peak.reshape(batch_shape) if config.with_max else None,
        thin=unbatch(mag) if config.nms else None,
        edges=unbatch(edges) if config.hysteresis else None,
        layout=layout,
        config=config,
    )


# ---------------------------------------------------------------------------
# The streaming engine: per-frame delta-skip + temporal hysteresis
# ---------------------------------------------------------------------------

def stream_block_shape(
    h: int,
    w: int,
    config: "EdgeConfig",
    *,
    backend: str = "torch",
    rgb: bool = False,
    dtype: str = "float32",
) -> Tuple[int, int]:
    """The ``(block_h, block_w)`` delta-tile grid of a stream of ``(h, w)``
    frames: K3's CTA tile. Explicit config fields win; otherwise ``cuda``
    consults the tuning cache (the f32 lane's slot, as the reference's
    Pallas backends do; K3 has no ring, so the tile must fit at depth 0)
    and ``torch`` takes the default tile. The reference's default is a TPU
    rule, so grids compare only when the config pins both."""
    if config.block_h and config.block_w:
        return config.block_h, config.block_w
    if backend == "torch":
        return ekern.default_block_shape(h, w, config.spec.size)
    bh, bw, _depth, _src = choose_block_shape(
        h, w, operator=config.operator, variant=config.variant, dtype=dtype,
        backend=backend, padding=config.padding, layout="rgb" if rgb else "gray",
        block_h=config.block_h, block_w=config.block_w, pipeline_depth=0, nms=config.nms,
    )
    return bh, bw


def _window_reach(n: int, b: int, g: int, t: int, r: int) -> Tuple[int, int]:
    """(up, down) reach, in whole tiles, of any tile's input window along
    one axis of length ``n`` tiled by ``b`` into ``g`` tiles, with clamped
    window extent ``t`` and stencil radius ``r`` (the reference's formula:
    interior, clamped at 0 and clamped at ``n - t``). Over-reach only costs
    the recompute of an unchanged tile, so the bounds round up."""
    if g <= 1:
        return 0, 0
    s = n - (g - 1) * b
    up = max(-(-r // b), -(-(t - s) // b))
    down = -(-(t - b) // b)
    return max(0, up), max(0, down)


def _dilate_blocks(
    changed: torch.Tensor, reach_h: Tuple[int, int], reach_w: Tuple[int, int]
) -> torch.Tensor:
    """OR-dilate the (B, gh, gw) change map so every tile whose input
    window can see a changed tile is marked for recompute."""
    (uh, dh), (uw, dw) = reach_h, reach_w
    if uh == dh == uw == dw == 0:
        return changed
    p = F.pad(changed.to(torch.float32), (uw, dw, uh, dh))
    y = F.max_pool2d(p[:, None], kernel_size=(uh + dh + 1, uw + dw + 1), stride=1)
    return y[:, 0] > 0


def stream_delta(
    x: torch.Tensor,
    state: "StreamState",
    config: "EdgeConfig",
    *,
    rgb: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile change test of ``x`` against the cached previous frame.

    ``x``: ``(B, H, W[, 3])`` in kernel dtype (u8 and f32 compares are
    exact). Returns ``(changed, skipped)``: the ``(B, gh, gw)`` bool
    recompute mask (the per-tile difference OR-dilated by the input
    window's reach) and the ``(B,)`` int32 count of skippable tiles. An
    uninitialized state marks every tile changed.
    """
    bh, bw = state.block
    h, w = (x.shape[-3], x.shape[-2]) if rgb else (x.shape[-2], x.shape[-1])
    b = x.shape[0]
    gh, gw = -(-h // bh), -(-w // bw)
    if not state.initialized:
        changed = torch.ones((b, gh, gw), dtype=torch.bool, device=x.device)
    else:
        diff = x != state.frame
        if rgb:
            diff = diff.any(dim=-1)
        blocks = ekern._block_max(diff.to(torch.float32), bh, bw) > 0
        config = config.resolved()
        reach = config.plan.linear_reach if config.plan is not None else config.spec.radius
        r_in = window_radius(reach, config.nms)
        th, tw = window_shape(h, w, bh, bw, r_in, align=ALIGN_INTERPRET)
        changed = _dilate_blocks(
            blocks,
            _window_reach(h, bh, gh, th, r_in),
            _window_reach(w, bw, gw, tw, r_in),
        )
    skipped = (gh * gw - changed.sum(dim=(-2, -1))).to(torch.int32)
    return changed, skipped


def _stream_epilogue(
    x, config, state, primary, bmax, skipped, *, batch_shape, layout
):
    """Shared tail of the streaming paths: peak from the (spliced) tile
    maxima, plain or temporal hysteresis, normalization, result and next
    state. Runs every frame, a fully spliced one too, because the temporal
    seed strength decays per frame."""
    from repro_torch.api import EdgeResult, StreamState

    need_peak = config.normalize or config.with_max or config.hysteresis
    peak = bmax.amax(dim=(-2, -1), keepdim=True) if need_peak else None

    edges = None
    new_seed = None
    if config.hysteresis:
        low, high = core_nms.resolve_thresholds(peak, config.low, config.high)
        if config.temporal:
            seeds, decayed = core_nms.temporal_seeds(state.seed, config.decay)
            edges = core_nms.hysteresis(primary, low, high, seed=seeds)
            new_seed = core_nms.update_seed_strength(decayed, edges)
        else:
            edges = core_nms.hysteresis(primary, low, high)

    mag = primary
    if config.normalize:
        mag = _normalize(mag, peak)

    new_state = StreamState(
        frame=x, primary=primary, bmax=bmax, seed=new_seed,
        block=state.block, initialized=True,
    )

    def unbatch(a):
        return a.reshape(batch_shape + tuple(a.shape[-2:]))

    result = EdgeResult(
        magnitude=unbatch(mag),
        peak=peak.reshape(batch_shape) if config.with_max else None,
        thin=unbatch(mag) if config.nms else None,
        edges=unbatch(edges) if config.hysteresis else None,
        skipped=skipped.reshape(batch_shape),
        layout=layout,
        config=config,
    )
    return result, new_state


def _check_stream_config(config: "EdgeConfig") -> None:
    if config.plan is not None and config.plan.pre_stages:
        # K3 runs one stage on the changed tiles; a single-operator plan
        # (gradient [+ nms]) resolves to its plain operator and runs.
        raise ValueError(
            f"streaming runs the single-stage masked kernel; plan "
            f"{config.plan.name!r} has pre-stages and is not supported on "
            "the stream path (use edge_detect for fused multi-stage plans)"
        )
    if config.shard is not None:
        raise ValueError(
            "streaming is single-device per stream group for now; drop "
            "config.shard (batch parallelism comes from grouping streams)"
        )
    if config.with_components or config.with_orientation:
        raise ValueError(
            "streaming caches the primary map only; with_components/"
            "with_orientation are not supported on the stream path"
        )
    if config.precision == "int" or config.pipeline_depth is not None:
        # precision="auto" stays f32 here, as in the reference.
        raise ValueError(
            "streaming runs the f32 masked-grid kernel; explicit "
            "precision='int' / pipeline_depth are not supported on the "
            "stream path"
        )


def edge_stream(
    images,
    config: "EdgeConfig",
    state: Optional["StreamState"] = None,
    *,
    layout: Optional[str] = None,
    changed: Optional[torch.Tensor] = None,
    device=None,
) -> tuple:
    """One streaming frame step: delta-skip compute + temporal epilogue.

    ``images``: one frame per stream, ``HW``/``HWC`` or a same-resolution
    batch ``NHW``/``NHWC``. ``state`` is the previous step's
    :class:`~repro_torch.api.StreamState` (``None`` = cold start: every
    tile recomputes and the caches fill). ``changed`` lets a caller that
    already ran :func:`stream_delta` pass the mask in. ``device`` as for
    :func:`edge`.

    The ``cuda`` backend runs K3, which recomputes the flagged tiles and
    copies the cached ones; ``torch`` recomputes the frame and selects per
    tile. Either way the output equals a stateless full recompute bit for
    bit. Returns ``(EdgeResult, StreamState)``; ``result.skipped`` counts
    the delta-skipped tiles per stream.
    """
    from repro_torch.api import StreamState

    config = config.resolved()
    _check_stream_config(config)
    dev = resolve_device(device)
    backend = resolve_backend(config.backend, dev)
    x, layout, rgb, batch_shape, h, w = _flatten(images, layout, dev)
    if "T" in layout or layout.count("N") > 1:
        raise ValueError(
            "streaming takes one frame per stream per call, not a video "
            f"stack (layout {layout!r}); iterate frames through the state"
        )

    if state is None:
        state = StreamState.init(x.shape[0], h, w, config, rgb=rgb, dtype=x.dtype,
                                 device=dev)
    bh, bw = state.block
    if tuple(state.frame.shape) != tuple(x.shape):
        raise ValueError(
            f"stream state was built for frames {tuple(state.frame.shape)}, got "
            f"{tuple(x.shape)}; streams of different shape need their own state"
        )

    if changed is None:
        changed, skipped = stream_delta(x, state, config, rgb=rgb)
    else:
        gh, gw = state.grid
        skipped = (gh * gw - changed.sum(dim=(-2, -1))).to(torch.int32)

    run = ekern.edge_stream_cuda if backend == "cuda" else ekern.edge_stream_plain
    primary, bmax = run(
        x, state.primary, state.bmax, changed.to(torch.int32).contiguous(),
        spec=config.spec, variant=config.variant, directions=config.directions,
        padding=config.padding, block_h=bh, block_w=bw, rgb=rgb, out_nms=config.nms,
    )
    return _stream_epilogue(
        x, config, state, primary, bmax, skipped,
        batch_shape=batch_shape, layout=layout,
    )


def edge_stream_cached(
    config: "EdgeConfig",
    state: "StreamState",
    *,
    layout: str = "NHW",
) -> tuple:
    """The all-static fast path: a frame step with no kernel launch.

    When nothing changed across the group, the cached primary map and tile
    maxima are this frame's outputs; only the epilogue runs (the temporal
    seed strength still decays). Equal to :func:`edge_stream` on the same
    static frame, bit for bit.
    """
    config = config.resolved()
    _check_stream_config(config)
    if not state.initialized:
        raise ValueError(
            "edge_stream_cached needs an initialized state (run at least "
            "one edge_stream step first)"
        )
    batch_shape = () if layout in ("HW", "HWC") else tuple(state.primary.shape[:1])
    skipped = torch.full((state.primary.shape[0],), state.tiles, dtype=torch.int32,
                         device=state.primary.device)
    return _stream_epilogue(
        state.frame, config, state, state.primary, state.bmax, skipped,
        batch_shape=batch_shape, layout=layout,
    )
