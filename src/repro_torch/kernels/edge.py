"""K1, K2 and K3, the edge kernels: their CUDA wrappers and their plain PyTorch versions.

``edge_cuda`` launches K1, ``csrc/edge.cu`` (the Hopper port of
``repro/kernels/edge.py::_kernel``), or with ``pipeline_depth`` 2..8 K2,
``csrc/edge_pipelined.cu`` (the port of ``_pipelined_kernel``: K1's walk
fed by a ring of windows that a producer warp copies ahead, on a
persistent grid), through ``edge_pipelined_cuda``; ``edge_stream_cuda`` launches K3,
``csrc/edge_stream.cu`` (the port of ``_stream_kernel``: K1's tile body on
the changed tiles and 16-byte copies of the cached ones, on a persistent
grid that compacts the mask itself). K1 and K2 take a stencil ``plan``
too: its pre-stages run on the tile in shared memory ahead of the
gradient, in the same launch (the reference's ``_emit_outputs`` with
``plan=``). They take CUDA
tensors and raise on anything else. ``edge_plain`` and
``edge_stream_plain`` compute the same outputs from ``repro_torch.core``
functions on any device; the CPU lane runs them, and the kernels are held
against them on the card. ``precision="int"`` selects the exact integer
lane of K1, K2 and the plain version (u8 gray input, ``core/ladder.py``).

One K1 launch takes the raw ``(N, H, W)`` u8/f32 gray or ``(N, H, W, 3)``
RGB batch and emits the magnitude, or the ``(N, D, H, W)`` components, or
with ``out_nms`` the thin map (plus, on demand, the centre components and
the un-thinned magnitude), and optionally the ``(N, gh, gw)`` per-tile max
of the un-thinned magnitude over the ``block_h x block_w`` output tiles,
the source of the per-image peak. One K3 launch recomputes the tiles a mask
flags and splices the cached primary map and maxima everywhere else.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core import ladder
from repro_torch.core.filters import OperatorSpec, get_operator, resolve_plan
from repro_torch.core.nms import TAN_PI8_F32, thin_map
from repro_torch.core.sobel import _pad, magnitude, plan_components, spec_components, to_lane
from repro_torch.kernels.tiling import PAD_MODES, luma, window_radius

__all__ = [
    "edge_cuda",
    "edge_pipelined_cuda",
    "edge_plain",
    "edge_stream_cuda",
    "edge_stream_plain",
    "default_block_shape",
    "kernel_dtype",
    "window_smem_bytes",
    "launch_smem_bytes",
    "pipelined_smem_bytes",
    "pipelined_layout",
    "pre_plane_words",
    "kernel_plan",
    "pipelined_bands",
    "pipelined_tiles",
    "stream_vector_copy",
    "const_taps_instance",
    "PIPELINE_DEPTHS",
]

_VARIANT_CODES = {"direct": 0, "separable": 1, "v1": 2, "v2": 3}
_PADDING_CODES = {p: i for i, p in enumerate(PAD_MODES)}
KMAX = 9                 # largest operator size csrc/edge.cu instantiates
SMEM_MAX = 232448        # shared memory one CTA may opt into on an H100
SMEM_DEFAULT = 48 * 1024  # default tiles stay under the no-opt-in limit
PIPELINE_DEPTHS = range(2, 9)  # K2's ring depths; 0 means K1
K2_CONSUMERS = 512       # K2's threads a CTA aims at (csrc/edge_pipelined.cu)
K2_CONSUMERS_WIDE = 384  # the same for operator sizes 7 and 9
K2_MAX_THREADS = 512     # K2's largest CTA
MAX_PRE = 4              # pre-stages K1 and K2 take (csrc/edge_tile.cuh, PreT)
# Pre-stage codes of csrc/edge_tile.cuh: a separable or dense linear stage, a
# window max or min, a pointwise abs or square.
_PRE_SEP, _PRE_DENSE, _PRE_MAX, _PRE_MIN, _PRE_ABS, _PRE_SQUARE = range(6)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def kernel_plan(plan, out_nms: bool):
    """The plan K1, K2 and the plain version run, after the reference's
    checks: ``None`` for no plan and for a single-operator plan (the
    operator path, unchanged); raises for a plan without a gradient stage
    and for ``out_nms`` other than ``plan.nms``."""
    plan = resolve_plan(plan)
    if plan is None:
        return None
    if plan.gradient is None:
        raise ValueError(
            f"plan {plan.name!r} has no gradient stage; the edge kernel "
            "emits direction components"
        )
    if out_nms != plan.nms:
        raise ValueError(
            f"plan {plan.name!r} {'ends in' if plan.nms else 'has no'} "
            f"NMS stage but out_nms={out_nms}; the plan is the single "
            "source of truth — pass out_nms=plan.nms"
        )
    return None if plan.single_operator else plan


def _plan_spec(spec, plan):
    """The gradient operator of a call: ``plan.gradient`` with a plan (a
    ``spec`` passed beside it must be that operator)."""
    if plan is None:
        if spec is None:
            raise ValueError("pass spec= (or a plan with a gradient stage)")
        return spec
    if spec is not None and spec != plan.gradient:
        raise ValueError(
            f"spec {spec.name!r} is not the gradient stage of plan {plan.name!r}"
        )
    return plan.gradient


def _fused(plan):
    """The plan with pre-stages, or None (no plan, or one operator)."""
    plan = resolve_plan(plan)
    return plan if plan is not None and plan.pre_stages else None


def pre_plane_words(block_h: int, block_w: int, plan, nms: bool = False) -> int:
    """4-byte words of the plane K1 and K2 keep beside the window for a
    plan's pre-stages (``csrc/edge_tile.cuh``, ``pre_plane_words``): the
    output of the first pre-stage with a radius, ``(bh + pad2 + 2 rem) x
    (bw + pad2 + 2 rem)``, ``pad2`` 2 with NMS, ``rem`` the radii still to
    come. Later stages alternate between the window and this plane (each
    output is smaller than the one before); pointwise stages run in place.
    0 without a plan or when every pre-stage is pointwise."""
    plan = _fused(plan)
    if plan is None:
        return 0
    pad2 = 2 if nms else 0
    remaining = plan.linear_reach
    for stage in plan.pre_stages:
        remaining -= stage.radius
        if stage.radius > 0:
            return (block_h + pad2 + 2 * remaining) * (block_w + pad2 + 2 * remaining)
    return 0


def launch_smem_bytes(block_h: int, block_w: int, radius: int, nms: bool = False,
                      plan=None) -> int:
    """The dynamic shared memory K1 and K3 ask for at launch
    (``csrc/edge_tile.cuh``, ``tile_smem_bytes``, plus a plan's pre-stage
    plane in ``csrc/edge.cu``): the f32 halo window of the ``block_h x
    block_w`` tile at the window's reach (``radius``, or a plan's
    ``linear_reach``, + 1 with NMS)."""
    fused = _fused(plan)
    halo = window_radius(fused.linear_reach if fused is not None else radius, nms)
    return 4 * ((block_h + 2 * halo) * (block_w + 2 * halo)
                + pre_plane_words(block_h, block_w, fused, nms))


def window_smem_bytes(block_h: int, block_w: int, radius: int, nms: bool = False,
                      plan=None) -> int:
    """The shared-memory footprint a tile is held to for K1 and K3: what
    they allocate (:func:`launch_smem_bytes`), and with NMS also the f32
    magnitude of the ``(block + 2)`` inner tile and a sector byte per
    output pixel. K1 and K3 keep those two in registers; the bound still
    counts them, so that the tiles legal for an NMS call did not change. A
    ``plan`` with pre-stages is held to what K1 allocates for it: the
    window at its composed reach (``plan.linear_reach`` in place of
    ``radius``) and its plane (:func:`pre_plane_words`), with no NMS
    buffers."""
    smem = launch_smem_bytes(block_h, block_w, radius, nms, plan)
    if nms and _fused(plan) is None:
        smem += 4 * (block_h + 2) * (block_w + 2) + block_h * block_w
    return smem


def _align16(b: int) -> int:
    return _round_up(b, 16)


def _tile_threads(bw: int, nms: bool) -> int:
    """K1's CTA (``csrc/edge_tile.cuh``, ``tile_threads``): a thread per
    column, with NMS a warp per 30 columns, at most 384."""
    t = _round_up(bw, 30) // 30 * 32 if nms else _round_up(bw, 32)
    return min(t, 384)


def pipelined_smem_bytes(bh: int, bw: int, radius: int, depth: int, in_bytes: int,
                         channels: int, nms: bool, plan=None) -> int:
    """Dynamic shared memory of one K2 CTA: :func:`pipelined_layout`'s
    ``total``."""
    return pipelined_layout(bh, bw, radius, depth, in_bytes, channels, nms, plan)["total"]


def pipelined_layout(bh: int, bw: int, radius: int, depth: int, in_bytes: int,
                     channels: int, nms: bool, plan=None) -> dict:
    """K2's dynamic shared memory (``csrc/edge_pipelined.cu``,
    ``pipelined_layout``): ``{"eh", "ew", "slots", "barriers", "total"}``
    (a slot and an mbarrier per ring window; the bytes), for the window of ``eh x ew = (bh + 2 R_in) x
    (bw + 2 R_in)`` (``R_in`` = radius, + 1 with NMS):

      * the ring: ``depth`` slots, each the larger of the two copy routes'
        layouts of the raw window, rounded up to 128 B. cp.async: ``eh``
        rows of the window row's ``ew x channels x in_bytes`` bytes behind
        up to 15 of lead, in 16-byte words. TMA (gray only): ``chunks x
        row_boxes`` boxes of ``box_h`` rows x ``box_w`` elements (at most
        256 each, ``box_w`` a multiple of 16 B) covering the window and up
        to 15 B of lead, each box's bytes rounded up to 128;
      * an int32 byte offset per window row and per window column;
      * K1's window, ``eh x ew`` 4-byte values (f32, or int32 on the
        integer lane), and with a ``plan`` its pre-stage plane
        (:func:`pre_plane_words`); a plan with pre-stages also widens the
        window to its composed reach (``plan.linear_reach`` in place of
        ``radius``);
      * two buffers of warp maxima (``K2_MAX_THREADS / 32`` f32 each) and an
        mbarrier (8 B) per slot;
      * 128 B for the layout itself, which the kernel keeps in shared memory;

    each part but the barriers starting on 16 B.
    """
    fused = _fused(plan)
    if fused is not None:
        radius = fused.linear_reach
    r_in = radius + int(bool(nms))
    eh, ew = bh + 2 * r_in, bw + 2 * r_in
    slot = eh * _round_up(ew * channels * in_bytes + 15, 16)
    if channels == 1:
        m = 16 // in_bytes
        units = ew + m - 1
        chunks = -(-units // (256 // m * m))
        box_w = _round_up(-(-units // chunks), m)
        row_boxes = -(-eh // 256)
        box_h = -(-eh // row_boxes)
        slot = max(slot, chunks * row_boxes * _round_up(box_h * box_w * in_bytes, 128))
    off = depth * _round_up(slot, 128)
    off = _align16(off + 4 * eh)
    off = _align16(off + 4 * ew)
    off = _align16(off + 4 * eh * ew)
    off = _align16(off + 4 * pre_plane_words(bh, bw, fused, nms))
    off = _align16(off + 2 * (K2_MAX_THREADS // 32) * 4 + depth * 8)
    return dict(eh=eh, ew=ew, slots=depth, barriers=depth, total=off + 128)


def pipelined_bands(bh: int, bw: int, nms: bool, size: int = 5) -> list:
    """The rows each band of K2's threads walks (``csrc/
    edge_pipelined.cu``, ``pipelined_bands``): as many of K1's CTAs as fit
    ``K2_CONSUMERS`` threads (``K2_CONSUMERS_WIDE`` for operators of size 7
    and 9), at most one per 16 rows, at least one, the tile's ``bh`` rows
    split evenly; ``[(first row, end row), ...]``."""
    consumers = K2_CONSUMERS if size <= 5 else K2_CONSUMERS_WIDE
    bands = max(1, min(consumers // _tile_threads(bw, nms), bh // 16))
    per = -(-bh // bands)
    return [(b * per, min(bh, (b + 1) * per)) for b in range(bands)]


def pipelined_tiles(n_tiles: int, ctas: int) -> list:
    """K2's persistent schedule: CTA ``b`` of ``ctas`` takes tiles ``b, b +
    ctas, ...`` of the batch's ``n_tiles`` (raster order, ``(n, gh, gw)``);
    one list of tile indices per CTA."""
    return [list(range(b, n_tiles, ctas)) for b in range(ctas)]


def stream_vector_copy(prev_primary: torch.Tensor, primary: torch.Tensor, w: int, bw: int) -> bool:
    """Whether K3 copies the cached tiles by 16-byte vectors: both maps'
    bases on 16 bytes (``data_ptr()``, a view's offset included) and ``w``
    and ``bw`` multiples of 4, so that every row of every tile starts on 16
    bytes and ends on a whole vector. Else it copies a float at a time;
    both routes give the same bits."""
    return (prev_primary.data_ptr() % 16 == 0 and primary.data_ptr() % 16 == 0
            and w % 4 == 0 and bw % 4 == 0)


def default_block_shape(h: int, w: int, size: int = 5) -> tuple:
    """(block_h, block_w) of the CTA output tile when none is given.

    32 x 128 gives each of the 256 threads 16 pixels, with rows a multiple
    of the 32-thread warp so stores coalesce. Small images shrink the tile;
    a large operator halves it until the halo window fits ``SMEM_DEFAULT``.
    """
    r = size // 2
    bh = min(32, _round_up(h, 8))
    bw = min(128, _round_up(w, 32))
    while window_smem_bytes(bh, bw, r) > SMEM_DEFAULT and (bh > 8 or bw > 32):
        if bw >= bh and bw > 32:
            bw //= 2
        else:
            bh = max(8, bh // 2)
    return bh, bw


def kernel_dtype(x: torch.Tensor) -> torch.Tensor:
    """uint8 stays uint8 (a quarter of the input bytes; the kernel casts in
    shared memory); every other dtype is cast to float32."""
    if x.dtype == torch.uint8:
        return x
    return x.to(torch.float32)


def _dims(x: torch.Tensor, rgb: bool):
    if rgb:
        if x.ndim != 4 or x.shape[-1] != 3:
            raise ValueError(f"rgb input must be (N, H, W, 3), got {tuple(x.shape)}")
    elif x.ndim != 3:
        raise ValueError(f"gray input must be (N, H, W), got {tuple(x.shape)}")
    return x.shape[0], x.shape[1], x.shape[2]


def _grid(h: int, w: int, block_h: int, block_w) -> tuple:
    bw = block_w if block_w else w
    if block_h < 1 or bw < 1:
        raise ValueError(f"block shape must be positive, got ({block_h}, {bw})")
    return block_h, bw, -(-h // block_h), -(-w // bw)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _block_max(mag: torch.Tensor, bh: int, bw: int) -> torch.Tensor:
    """(N, H, W) -> (N, gh, gw) max over each output tile's in-image pixels."""
    n, h, w = mag.shape
    gh, gw = -(-h // bh), -(-w // bw)
    padded = mag.new_zeros((n, gh * bh, gw * bw))
    padded[:, :h, :w] = mag
    return padded.view(n, gh, bh, gw, bw).amax(dim=(2, 4))


def edge_plain(
    x: torch.Tensor,
    *,
    spec: "OperatorSpec | None" = None,
    variant: str,
    directions: int,
    padding: str = "reflect",
    block_h: int = 64,
    block_w: "int | None" = None,
    rgb: bool = False,
    out_components: bool = False,
    out_nms: bool = False,
    out_mag: bool = False,
    with_max: bool = False,
    precision: str = "f32",
    pipeline_depth: int = 0,
    plan=None,
):
    """The plain PyTorch version of :func:`edge_cuda`, of K1 and K2 alike:
    same arguments, same outputs, on any device.

    Luma (RGB) or the f32 cast (the raw u8 frame on the integer lane), the
    boundary-extended image (``core.sobel._pad``), ``spec_components`` and
    ``magnitude``, or with ``out_nms`` ``core.nms.thin_map``; the per-tile
    max is taken over the same ``block_h x block_w`` tiles. A ring depth
    changes where K2 keeps its input, not the values, so ``pipeline_depth``
    is checked and otherwise ignored, as the reference's XLA lane does.
    ``plan`` chains the plan's pre-stages ahead of the gradient on the
    image extended once by the composed reach (``core.sobel.
    plan_components``), with the checks of :func:`kernel_plan`.
    """
    _check_out_mag(out_nms, out_mag)
    _check_depth(pipeline_depth)
    plan = kernel_plan(plan, out_nms)
    spec = _plan_spec(spec, plan)
    _check_precision(x, spec, rgb, precision, plan)
    n, h, w = _dims(x, rgb)
    bh, bw, _gh, _gw = _grid(h, w, block_h, block_w)
    if precision == "int":
        gray = x  # the ladder casts the u8 frame to its integer dtype
    else:
        gray = luma(x) if rgb else x.to(torch.float32)
    if out_nms:
        thin, comps, mag = thin_map(gray, spec, variant=variant, directions=directions,
                                    padding=padding, precision=precision, plan=plan)
        outs = [thin]
        if out_components:
            outs.append(torch.stack(comps, dim=1))
        if out_mag:
            outs.append(mag.contiguous())
    else:
        reach = plan.linear_reach if plan is not None else spec.radius
        xp, _, _ = _pad(to_lane(gray, spec, precision, plan=plan), reach, padding)
        if plan is not None:
            comps = plan_components(xp, plan, h, w, variant, directions)
        else:
            comps = spec_components(xp, spec, h, w, variant, directions)
        if precision == "int":
            comps = tuple(c.to(torch.float32) for c in comps)
        mag = magnitude(comps) if (with_max or not out_components) else None
        outs = [torch.stack(comps, dim=1) if out_components else mag]
    if with_max:
        outs.append(_block_max(mag, bh, bw))
    return outs[0] if len(outs) == 1 else tuple(outs)


def edge_stream_plain(
    x: torch.Tensor,
    prev_primary: torch.Tensor,
    prev_bmax: torch.Tensor,
    mask: torch.Tensor,
    *,
    spec: OperatorSpec,
    variant: str,
    directions: int,
    padding: str = "reflect",
    block_h: int = 64,
    block_w: "int | None" = None,
    rgb: bool = False,
    out_nms: bool = False,
):
    """The plain PyTorch version of :func:`edge_stream_cuda`: a full
    :func:`edge_plain` recompute, then a per-tile select against the caches
    (the reference's XLA stream lane). Returns ``(primary, bmax)``."""
    n, h, w = _dims(x, rgb)
    bh, bw, gh, gw = _grid(h, w, block_h, block_w)
    _check_stream_shapes(prev_primary, prev_bmax, mask, n, h, w, gh, gw, bh, bw)
    fresh, fresh_bmax = edge_plain(x, spec=spec, variant=variant, directions=directions,
                                   padding=padding, block_h=bh, block_w=bw, rgb=rgb,
                                   out_nms=out_nms, with_max=True)
    changed = mask.to(torch.bool)
    pixels = changed.repeat_interleave(bh, dim=-2).repeat_interleave(bw, dim=-1)[:, :h, :w]
    return torch.where(pixels, fresh, prev_primary), torch.where(changed, fresh_bmax, prev_bmax)


def _check_depth(pipeline_depth: int) -> None:
    if pipeline_depth and not (isinstance(pipeline_depth, int)
                               and pipeline_depth in PIPELINE_DEPTHS):
        raise ValueError(
            f"pipeline_depth must be 0 (automatic) or 2..8 (manual DMA "
            f"ring), got {pipeline_depth}"
        )


def _check_precision(x: torch.Tensor, spec: OperatorSpec, rgb: bool, precision: str,
                     plan=None) -> bool:
    """True for the integer lane, after checking that it covers ``x``
    (``core.ladder.int_lane_eligible``, or ``plan_int_eligible`` for a
    plan); False for f32."""
    if precision not in ("f32", "int"):
        # "auto" is a dispatch-level policy (kernels.dispatch.resolve_precision).
        raise ValueError(f"unknown precision {precision!r}; expected 'f32' or 'int'")
    if precision == "f32":
        return False
    if plan is not None:
        ok, reason = ladder.plan_int_eligible(plan, rgb=rgb, input_dtype=x.dtype)
    else:
        ok, reason = ladder.int_lane_eligible(spec, rgb=rgb, input_dtype=x.dtype)
    if not ok:
        raise ValueError(f"precision='int' unavailable: {reason}")
    return True


def _check_out_mag(out_nms: bool, out_mag: bool) -> None:
    if out_mag and not out_nms:
        raise ValueError("out_mag only applies with out_nms (the magnitude is already "
                         "the primary output otherwise)")


def _check_stream_shapes(prev_primary, prev_bmax, mask, n, h, w, gh, gw, bh, bw) -> None:
    if tuple(prev_bmax.shape) != (n, gh, gw) or tuple(mask.shape) != (n, gh, gw):
        raise ValueError(
            f"prev_bmax/mask {tuple(prev_bmax.shape)}/{tuple(mask.shape)} do not match the "
            f"({n}, {gh}, {gw}) tile grid of block ({bh}, {bw})"
        )
    if tuple(prev_primary.shape) != (n, h, w):
        raise ValueError(f"prev_primary {tuple(prev_primary.shape)} is not ({n}, {h}, {w})")


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, its entry points typed."""
    from repro_torch.kernels import build

    lib = build.load(name)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    geometry = [p, i, i, i, i, i, i, i, i, i, i, i, i, f, p]
    # repro_edge_launch: const_taps, acc_int, 4 outputs, stream, pre-stages;
    # repro_pipelined_launch: const_taps, acc_int, depth, tma, 4 outputs,
    # stream, pre-stages;
    # repro_stream_launch: const_taps, mask, 2 caches, 2 outputs + stream.
    # Each returns a cudaError_t as int.
    entry, extra = {
        "edge": ("repro_edge_launch", [i, i] + [p] * 6),
        "edge_pipelined": ("repro_pipelined_launch", [i, i, i, i] + [p] * 6),
        "edge_stream": ("repro_stream_launch", [i] + [p] * 5 + [i, p, p]),
    }[name]
    launch = getattr(lib, entry)
    launch.argtypes = geometry + extra
    launch.restype = i
    if name == "edge_pipelined":
        # pipelined_layout's footprint and pipelined_bands' count, held
        # against pipelined_smem_bytes and pipelined_bands by chip_smoke.py
        # and the gpu tests (not on every launch).
        lib.repro_pipelined_smem_bytes.argtypes = [i] * 7
        lib.repro_pipelined_smem_bytes.restype = ctypes.c_longlong
        lib.repro_pipelined_plan_smem_bytes.argtypes = [i] * 8
        lib.repro_pipelined_plan_smem_bytes.restype = ctypes.c_longlong
        lib.repro_pipelined_bands.argtypes, lib.repro_pipelined_bands.restype = [i] * 4, i
    for fn in ("repro_taps_len", "repro_max_size"):
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = [], i
    if name != "edge_stream":
        lib.repro_pre_len.argtypes, lib.repro_pre_len.restype = [], i
        if lib.repro_pre_len() != _pre_len():
            raise RuntimeError(f"csrc/{name}.cu's PreT layout differs from _pack_pre")
    lib.repro_error_string.argtypes, lib.repro_error_string.restype = [i], ctypes.c_char_p
    if lib.repro_max_size() != KMAX:
        raise RuntimeError(f"csrc/{name}.cu and kernels/edge.py disagree on KMAX")
    if lib.repro_taps_len() != _taps_len():
        raise RuntimeError(f"csrc/{name}.cu's Taps layout differs from _pack_taps")
    lib.repro_default_taps.argtypes, lib.repro_default_taps.restype = [p], None
    built_in = np.zeros(_taps_len(), np.float32)
    lib.repro_default_taps(built_in.ctypes.data)
    fields = _default_fields()
    if not np.array_equal(built_in[fields], _default_taps()[fields]):
        raise RuntimeError(f"csrc/{name}.cu's compile-time sobel5 taps differ from "
                           "_pack_taps(get_operator('sobel5'))")
    return lib


def _raise_on_error(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err != 0:
        text = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {text} (cudaError {err})")


# The packed ``Taps`` struct (csrc/edge_tile.cuh), field by field in order:
# name -> shape, every element an f32.
_TAPS_FIELDS = (("dense", (4, KMAX, KMAX)), ("col", (2, KMAX)), ("row", (2, KMAX)),
                ("v2", (3, KMAX)), ("sym", (2, KMAX, KMAX)), ("sym_pass", (2, KMAX)),
                ("sym_neg", (2, KMAX)))


def _taps_offsets() -> dict:
    """Each field's offset into the packed ``Taps``."""
    out, off = {}, 0
    for name, shape in _TAPS_FIELDS:
        out[name] = off
        off += int(np.prod(shape))
    return out


def _taps_len() -> int:
    return sum(int(np.prod(shape)) for _, shape in _TAPS_FIELDS)


def _sym_plan(dense: np.ndarray):
    """``core.sobel._sym_rowpass``'s pass assignment: the distinct row
    vectors, and per row its pass index (-1 = zero row) and negation flag."""
    vecs, pass_of, neg = [], [], []
    index = {}
    for r_ in np.asarray(dense, np.float32):
        if not np.any(r_):
            pass_of.append(-1)
            neg.append(0)
            continue
        key, nkey = tuple(r_.tolist()), tuple((-r_).tolist())
        if key in index:
            pass_of.append(index[key])
            neg.append(0)
        elif nkey in index:
            pass_of.append(index[nkey])
            neg.append(1)
        else:
            index[key] = len(vecs)
            vecs.append(r_)
            pass_of.append(index[key])
            neg.append(0)
    return vecs, pass_of, neg


@functools.lru_cache(maxsize=64)
def _pack_taps(spec: OperatorSpec) -> np.ndarray:
    """The flat f32 ``Taps`` struct of ``csrc/edge.cu`` for ``spec``."""
    k, K = spec.size, KMAX
    dense = np.zeros((4, K, K), np.float32)
    bank = np.asarray(spec.taps, np.float32)[:4]
    dense[: len(bank), :k, :k] = bank
    col = np.zeros((2, K), np.float32)
    row = np.zeros((2, K), np.float32)
    for d in range(2):
        fac = spec.sep_factors(d)
        if fac is not None:
            col[d, :k], row[d, :k] = fac
    v2 = np.zeros((3, K), np.float32)
    if spec.v2_factors is not None:
        for a, arr in enumerate(spec.v2_arrays()):
            v2[a, :k] = arr
    sym = np.zeros((2, K, K), np.float32)
    sym_pass = np.full((2, K), -1.0, np.float32)
    sym_neg = np.zeros((2, K), np.float32)
    if 4 in spec.directions:
        for s, dm in enumerate((spec.kd_plus_dense(), spec.kd_minus_dense())):
            vecs, pass_of, neg = _sym_plan(dm)
            for p_, v in enumerate(vecs):
                sym[s, p_, :k] = v
            sym_pass[s, :k] = pass_of
            sym_neg[s, :k] = neg
    flat = np.concatenate([
        dense.ravel(), col.ravel(), row.ravel(), v2.ravel(),
        sym.ravel(), sym_pass.ravel(), sym_neg.ravel(),
    ]).astype(np.float32)
    if flat.size != _taps_len():
        raise AssertionError("Taps packing out of step with _taps_len")
    flat.setflags(write=False)
    return flat


def _pre_len() -> int:
    """Length of the packed ``PreT`` (csrc/edge_tile.cuh): the count, the
    composed reach, a code and a size per stage, a ``KMAX x KMAX`` tap
    block per stage."""
    return 2 + 2 * MAX_PRE + MAX_PRE * KMAX * KMAX


@functools.lru_cache(maxsize=64)
def _pack_pre(plan, spec: OperatorSpec) -> np.ndarray:
    """The flat f32 ``PreT`` of ``csrc/edge_tile.cuh``: how many pre-stages
    K1 and K2 run, the composed linear reach (the window's radius without
    NMS; ``spec.radius`` with no plan), and per stage its code, its size
    ``2r + 1`` and its taps (a separable linear stage: the row factor at
    ``[0, K)`` and the column factor at ``[KMAX, KMAX + K)``; a dense one:
    its ``K x K`` taps at row pitch ``KMAX``)."""
    flat = np.zeros(_pre_len(), np.float32)
    kinds = flat[2:2 + MAX_PRE]
    sizes = flat[2 + MAX_PRE:2 + 2 * MAX_PRE]
    taps = flat[2 + 2 * MAX_PRE:].reshape(MAX_PRE, KMAX, KMAX)
    plan = _fused(plan)
    flat[1] = plan.linear_reach if plan is not None else spec.radius
    for s_, stage in enumerate(plan.pre_stages if plan is not None else ()):
        _check_kernel_stage(plan, stage, s_)
        k = 2 * stage.radius + 1
        sizes[s_] = k
        if stage.kind == "linear":
            fac = stage.operator.sep_factors(0)
            if fac is not None:
                kinds[s_] = _PRE_SEP
                taps[s_, 0, :k], taps[s_, 1, :k] = fac[1], fac[0]
            else:
                kinds[s_] = _PRE_DENSE
                taps[s_, :k, :k] = stage.operator.bank(1)[0]
        elif stage.kind == "window_reduce":
            kinds[s_] = _PRE_MAX if stage.op == "max" else _PRE_MIN
        else:
            kinds[s_] = {"abs": _PRE_ABS, "square": _PRE_SQUARE}[stage.op]
        flat[0] = s_ + 1
    flat.setflags(write=False)
    return flat


def _check_kernel_stage(plan, stage, index: int) -> None:
    """What K1 and K2 refuse in a plan (no quiet retreat to the plain
    version): more than ``MAX_PRE`` pre-stages, a stage wider than
    ``KMAX``, a pointwise fn other than ``abs`` and ``square``."""
    if index >= MAX_PRE:
        raise ValueError(
            f"plan gate 'kernel-stage': plan {plan.name!r} has "
            f"{len(plan.pre_stages)} pre-stages; the kernels take at most {MAX_PRE}"
        )
    if 2 * stage.radius + 1 > KMAX:
        raise ValueError(
            f"plan gate 'kernel-stage': stage {stage.name!r} of plan {plan.name!r} is "
            f"{2 * stage.radius + 1} wide; the kernels take stages up to {KMAX}"
        )
    if stage.kind == "pointwise" and stage.op not in ("abs", "square"):
        raise ValueError(
            f"plan gate 'kernel-stage': pointwise fn {stage.op!r} of plan {plan.name!r} "
            "has no kernel form; the kernels take 'abs' and 'square'"
        )


@functools.lru_cache(maxsize=1)
def _default_taps() -> np.ndarray:
    """The packed taps of the default operator, sobel5 at ``SobelParams()``."""
    return _pack_taps(get_operator("sobel5"))


@functools.lru_cache(maxsize=1)
def _default_fields() -> np.ndarray:
    """Indices into the packed ``Taps`` of the fields the compile-time
    instance reads: the 5-tap row, column and v2 vectors, K_d+'s passes and
    its pass plan (``repro_default_taps`` fills exactly these)."""
    k, K = 5, KMAX
    off = _taps_offsets()
    idx = []
    for field, vectors in (("col", 2), ("row", 2), ("v2", 3), ("sym", K)):
        for v in range(vectors):
            idx.extend(off[field] + v * K + t for t in range(k))
    idx.extend(off["sym_pass"] + t for t in range(k))
    idx.extend(off["sym_neg"] + t for t in range(k))
    return np.asarray(idx)


def const_taps_instance(spec: OperatorSpec, variant: str, directions: int) -> bool:
    """Whether K1 and K3 run their compile-time instance for this call: the
    v2 ladder at 2 or 4 directions on an operator whose packed taps equal
    the default sobel5's. Decided by value, never by name:
    ``get_operator("sobel5", params)`` with other weights takes the run-time
    path, and so does every other operator, variant and size."""
    return (variant == "v2" and directions in (2, 4) and spec.size == 5
            and np.array_equal(_pack_taps(spec), _default_taps()))


def _check_launch(x: torch.Tensor, fn: str, spec: OperatorSpec, variant: str,
                  directions: int, padding: str) -> None:
    """What both kernels refuse: a CPU tensor, another dtype, a strided
    tensor, an operator above KMAX, unresolved options."""
    if x.device.type != "cuda":
        raise ValueError(
            f"{fn} launches a CUDA kernel and takes CUDA tensors, got a "
            f"{x.device.type} tensor; {fn.replace('cuda', 'plain')} is the plain version"
        )
    if x.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"{fn} takes uint8 or float32 input, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{fn} takes a contiguous tensor")
    if spec.size > KMAX:
        raise ValueError(
            f"operator {spec.name!r} is {spec.size}x{spec.size}; the kernels "
            f"instantiate sizes up to {KMAX}"
        )
    if variant not in spec.variants or directions not in spec.directions:
        raise ValueError(
            f"unresolved variant/directions {variant!r}/{directions} for operator "
            f"{spec.name!r}; resolve them with the spec first"
        )
    if variant != "direct" and (spec.sep_factors(0) is None or spec.sep_factors(1) is None):
        raise ValueError(f"operator {spec.name!r} has no separable factors for {variant!r}")
    if padding not in _PADDING_CODES:
        raise ValueError(f"unknown padding {padding!r}; expected one of {PAD_MODES}")


def _check_grid(n: int, bh: int, bw: int, gh: int, gw: int, radius: int, nms: bool,
                plan=None) -> None:
    smem = window_smem_bytes(bh, bw, radius, nms, plan=plan)
    if smem > SMEM_MAX:
        raise ValueError(
            f"tile {bh}x{bw} needs {smem} B of shared memory for its halo "
            f"window{' and NMS buffers' if nms else ''}"
            f"{' and pre-stage plane' if _fused(plan) else ''}; a CTA may use at most "
            f"{SMEM_MAX} B"
        )
    if n * gh * gw >= 2**31:
        raise ValueError(f"{n * gh * gw} tiles exceed the CUDA grid limit")


def _pipelined_smem(x: torch.Tensor, bh: int, bw: int, spec: OperatorSpec, depth: int,
                    rgb: bool, nms: bool, plan=None) -> int:
    """K2's footprint for this call; raises when it exceeds ``SMEM_MAX``
    (never a lower depth, never K1 in K2's place)."""
    smem = pipelined_smem_bytes(bh, bw, spec.radius, depth, x.element_size(), 3 if rgb else 1,
                                nms, plan=plan)
    if smem > SMEM_MAX:
        raise ValueError(
            f"pipeline_depth={depth} with tile {bh}x{bw} needs {smem} B of shared memory "
            f"(ring, offsets, window{' with its NMS halo' if nms else ''}"
            f"{', pre-stage plane' if _fused(plan) else ''}); a CTA may use "
            f"at most {SMEM_MAX} B"
        )
    return smem


def tma_route(x: torch.Tensor, w: int, rgb: bool) -> bool:
    """Whether K2 copies this tensor's windows by TMA boxes: gray frames
    whose base and row pitch are 16-byte aligned (the tensor map's rule;
    RGB rows would split pixels across boxes that start on 16 bytes). Else
    K2 takes 16-byte ``cp.async``. The shape decides; both routes give the
    same bits."""
    return not rgb and x.data_ptr() % 16 == 0 and (w * x.element_size()) % 16 == 0


def _geometry(x: torch.Tensor, rgb: bool, n: int, h: int, w: int, bh: int, bw: int,
              spec: OperatorSpec, variant: str, directions: int, padding: str,
              nms: bool) -> list:
    """The leading arguments both C entry points take."""
    return [x.data_ptr(), int(x.dtype == torch.uint8), int(rgb), n, h, w, bh, bw, spec.size,
            _VARIANT_CODES[variant], directions, _PADDING_CODES[padding], int(nms),
            float(TAN_PI8_F32), _pack_taps(spec).ctypes.data]


def _ptr(t: "torch.Tensor | None"):
    return None if t is None else t.data_ptr()


def edge_cuda(
    x: torch.Tensor,
    *,
    spec: "OperatorSpec | None" = None,
    variant: str,
    directions: int,
    padding: str = "reflect",
    block_h: int = 64,
    block_w: "int | None" = None,
    rgb: bool = False,
    out_components: bool = False,
    out_nms: bool = False,
    out_mag: bool = False,
    with_max: bool = False,
    precision: str = "f32",
    pipeline_depth: int = 0,
    instance: str = "auto",
    plan=None,
):
    """Launch K1 (``csrc/edge.cu``) on a contiguous CUDA tensor, or with
    ``pipeline_depth`` 2..8 K2 through :func:`edge_pipelined_cuda`.

    ``x``: ``(N, H, W)`` u8/f32 gray, or ``(N, H, W, 3)`` u8/f32 RGB when
    ``rgb``. ``variant``/``directions`` must be resolved against ``spec``.
    Outputs, in the reference's order (a bare tensor when only one), all
    f32:

      * the ``(N, H, W)`` magnitude, or with ``out_nms`` the thin map, or
        (without ``out_nms``) the ``(N, D, H, W)`` components when
        ``out_components``;
      * with ``out_nms``: the centre components when ``out_components``,
        then the un-thinned magnitude when ``out_mag``;
      * with ``with_max``: the ``(N, gh, gw)`` per-tile max of the
        un-thinned magnitude.

    ``precision="int"`` runs the exact integer lane (u8 gray input only;
    raises with the ladder's first failing gate otherwise); the outputs are
    f32 and bit-identical to the f32 lane.

    ``instance``: ``"auto"`` runs K1's compile-time instance where
    :func:`const_taps_instance` says it applies and the run-time-taps
    instance elsewhere; ``"runtime"`` forces the run-time-taps instance (to
    hold the two against each other). Both give the same bits, on K1 and
    on K2.

    ``plan`` (a stencil plan or a registered name; ``spec`` may then be
    omitted) runs the plan's pre-stages on each tile in shared memory ahead
    of the gradient walk, in the same launch, on the window of its composed
    reach (:func:`kernel_plan` checks it; a single-operator plan runs the
    operator path unchanged). ``precision="int"`` then needs
    ``core.ladder.plan_int_eligible``. A plan the kernels cannot take
    raises naming ``plan gate 'kernel-stage'``.

    Launches on PyTorch's current stream and does not synchronise. Raises
    for a CPU tensor, an input the kernel does not take, or a launch the
    device refuses. ``edge_cuda.launches`` counts K1's launches,
    ``edge_cuda.int_launches`` those of them on the integer lane,
    ``edge_cuda.const_launches`` those on the compile-time instance and
    ``edge_cuda.plan_launches`` those that ran pre-stages.
    """
    _check_depth(pipeline_depth)
    _check_instance(instance)
    if pipeline_depth:
        return edge_pipelined_cuda(
            x, spec=spec, variant=variant, directions=directions, padding=padding,
            block_h=block_h, block_w=block_w, rgb=rgb, out_components=out_components,
            out_nms=out_nms, out_mag=out_mag, with_max=with_max, precision=precision,
            pipeline_depth=pipeline_depth, instance=instance, plan=plan)
    _check_out_mag(out_nms, out_mag)
    plan = kernel_plan(plan, out_nms)
    spec = _plan_spec(spec, plan)
    _check_launch(x, "edge_cuda", spec, variant, directions, padding)
    acc_int = _check_precision(x, spec, rgb, precision, plan)
    pre = _pack_pre(plan, spec)
    n, h, w = _dims(x, rgb)
    bh, bw, gh, gw = _grid(h, w, block_h, block_w)
    _check_grid(n, bh, bw, gh, gw, spec.radius, out_nms, plan)

    outs, ptrs = _outputs(x, n, h, w, gh, gw, directions, out_components, out_nms, out_mag,
                          with_max)
    if n > 0 and h > 0 and w > 0:
        const = instance == "auto" and const_taps_instance(spec, variant, directions)
        lib = _lib("edge")
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.repro_edge_launch(
                *_geometry(x, rgb, n, h, w, bh, bw, spec, variant, directions, padding,
                           out_nms),
                int(const), int(acc_int), *ptrs, stream, pre.ctypes.data,
            )
        _raise_on_error(lib, "edge", err)
        edge_cuda.launches += 1
        edge_cuda.int_launches += int(acc_int)
        edge_cuda.const_launches += int(const)
        edge_cuda.plan_launches += int(plan is not None)
    return outs


edge_cuda.launches = 0
edge_cuda.int_launches = 0
edge_cuda.const_launches = 0
edge_cuda.plan_launches = 0


def _check_instance(instance: str) -> None:
    if instance not in ("auto", "runtime"):
        raise ValueError(f"unknown instance {instance!r}; expected 'auto' or 'runtime'")


def _outputs(x, n, h, w, gh, gw, directions, out_components, out_nms, out_mag, with_max):
    """K1's and K2's outputs, fresh f32 tensors: ``(result, pointers)``, the
    result in the reference's order (a bare tensor when only one) and the
    four pointers the C entry points take (``None`` for an unused one)."""
    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=x.device)

    primary = comps = mag = bmax = None
    if out_nms or not out_components:
        primary = empty(n, h, w)
    if out_components:
        comps = empty(n, directions, h, w)
    if out_mag:
        mag = empty(n, h, w)
    if with_max:
        bmax = empty(n, gh, gw)
    if out_nms:
        outs = [primary] + [t for t in (comps, mag) if t is not None]
    else:
        outs = [comps if out_components else primary]
    if with_max:
        outs.append(bmax)
    return (outs[0] if len(outs) == 1 else tuple(outs),
            [_ptr(primary), _ptr(comps), _ptr(mag), _ptr(bmax)])


def edge_pipelined_cuda(
    x: torch.Tensor,
    *,
    spec: "OperatorSpec | None" = None,
    variant: str,
    directions: int,
    padding: str = "reflect",
    block_h: int = 64,
    block_w: "int | None" = None,
    rgb: bool = False,
    out_components: bool = False,
    out_nms: bool = False,
    out_mag: bool = False,
    with_max: bool = False,
    precision: str = "f32",
    pipeline_depth: int = 2,
    instance: str = "auto",
    plan=None,
):
    """Launch K2 (``csrc/edge_pipelined.cu``), the prefetching kernel, with
    a ring of ``pipeline_depth`` (2..8) input windows.

    Arguments and outputs are :func:`edge_cuda`'s, bit for bit, and so are
    ``instance`` and ``plan``: K2 runs K1's walk on either instance, and a
    plan's pre-stages on each converted window. A persistent grid
    (as many CTAs as fit on the SMs) takes the batch's tiles in raster
    order (:func:`pipelined_tiles`); each CTA keeps its next
    ``pipeline_depth`` windows copied ahead of the one it walks, by TMA
    where :func:`tma_route` says so and by 16-byte ``cp.async`` elsewhere.
    Raises ``ValueError`` naming the bytes when the ring, the offsets and
    the window exceed ``SMEM_MAX`` (:func:`pipelined_smem_bytes`): it never
    lowers the depth and never launches K1 instead; a tensor map that cannot
    be encoded raises too. Launches on PyTorch's current stream and does not
    synchronise. ``edge_pipelined_cuda.launches`` counts the launches,
    ``int_launches`` those on the integer lane, ``const_launches`` those on
    the compile-time instance, ``plan_launches`` those that ran pre-stages,
    ``tma_launches`` and ``cp_async_launches`` those on each copy route.
    """
    if not (isinstance(pipeline_depth, int) and pipeline_depth in PIPELINE_DEPTHS):
        raise ValueError(f"K2 takes a ring depth of 2..8, got {pipeline_depth!r}")
    _check_instance(instance)
    _check_out_mag(out_nms, out_mag)
    plan = kernel_plan(plan, out_nms)
    spec = _plan_spec(spec, plan)
    _check_launch(x, "edge_pipelined_cuda", spec, variant, directions, padding)
    acc_int = _check_precision(x, spec, rgb, precision, plan)
    pre = _pack_pre(plan, spec)
    n, h, w = _dims(x, rgb)
    bh, bw, gh, gw = _grid(h, w, block_h, block_w)
    if n * gh * gw >= 2**31:
        raise ValueError(f"{n * gh * gw} tiles exceed the persistent grid's tile index")
    _pipelined_smem(x, bh, bw, spec, pipeline_depth, rgb, out_nms, plan)
    outs, ptrs = _outputs(x, n, h, w, gh, gw, directions, out_components, out_nms, out_mag,
                          with_max)
    if n > 0 and h > 0 and w > 0:
        const = instance == "auto" and const_taps_instance(spec, variant, directions)
        tma = tma_route(x, w, rgb)
        lib = _lib("edge_pipelined")
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.repro_pipelined_launch(
                *_geometry(x, rgb, n, h, w, bh, bw, spec, variant, directions, padding,
                           out_nms),
                int(const), int(acc_int), pipeline_depth, int(tma), *ptrs, stream,
                pre.ctypes.data,
            )
        _raise_on_error(lib, "edge_pipelined", err)
        edge_pipelined_cuda.launches += 1
        edge_pipelined_cuda.int_launches += int(acc_int)
        edge_pipelined_cuda.const_launches += int(const)
        edge_pipelined_cuda.plan_launches += int(plan is not None)
        edge_pipelined_cuda.tma_launches += int(tma)
        edge_pipelined_cuda.cp_async_launches += int(not tma)
    return outs


edge_pipelined_cuda.launches = 0
edge_pipelined_cuda.int_launches = 0
edge_pipelined_cuda.const_launches = 0
edge_pipelined_cuda.plan_launches = 0
edge_pipelined_cuda.tma_launches = 0
edge_pipelined_cuda.cp_async_launches = 0


def edge_stream_cuda(
    x: torch.Tensor,
    prev_primary: torch.Tensor,
    prev_bmax: torch.Tensor,
    mask: torch.Tensor,
    *,
    spec: OperatorSpec,
    variant: str,
    directions: int,
    padding: str = "reflect",
    block_h: int = 64,
    block_w: "int | None" = None,
    rgb: bool = False,
    out_nms: bool = False,
    instance: str = "auto",
):
    """Launch K3 (``csrc/edge_stream.cu``): recompute the tiles ``mask``
    flags, splice the cached tiles and maxima everywhere else.

    ``x`` as for :func:`edge_cuda`; ``prev_primary`` ``(N, H, W)`` f32 (the
    previous thin map with ``out_nms``, else magnitude), ``prev_bmax``
    ``(N, gh, gw)`` f32 and ``mask`` ``(N, gh, gw)`` int32, all contiguous
    CUDA tensors on the tile grid of ``block_h x block_w``. Returns fresh
    ``(primary, bmax)``, bit-identical to a full recompute where the
    unflagged tiles' input windows did not change. ``instance`` as for
    :func:`edge_cuda`: K3 runs K1's tile body, either instance.

    A persistent grid, as many CTAs as fit on the card, builds the list of
    changed tiles, then of unchanged ones, from ``mask`` on the device,
    walks the changed tiles with K1's tile body and copies the cached ones
    in bands of whole rows, by 16-byte vectors where
    :func:`stream_vector_copy` says so. The CTAs claim work from a counter
    of this device and stream, so calls on one stream run one after the
    other, as launches on a stream do.

    Launches on PyTorch's current stream and does not synchronise. Raises
    for a CPU tensor, an input the kernel does not take, or a launch the
    device refuses. ``edge_stream_cuda.launches`` counts the launches and
    ``edge_stream_cuda.vector_launches`` those that copied by vectors.
    """
    _check_instance(instance)
    _check_launch(x, "edge_stream_cuda", spec, variant, directions, padding)
    n, h, w = _dims(x, rgb)
    bh, bw, gh, gw = _grid(h, w, block_h, block_w)
    _check_stream_shapes(prev_primary, prev_bmax, mask, n, h, w, gh, gw, bh, bw)
    for name, t, dtype in (("prev_primary", prev_primary, torch.float32),
                           ("prev_bmax", prev_bmax, torch.float32),
                           ("mask", mask, torch.int32)):
        if t.device != x.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {x.device}, "
                             f"got {t.dtype} on {t.device}")
    _check_grid(n, bh, bw, gh, gw, spec.radius, out_nms)
    primary = torch.empty((n, h, w), dtype=torch.float32, device=x.device)
    bmax = torch.empty((n, gh, gw), dtype=torch.float32, device=x.device)
    if n > 0 and h > 0 and w > 0:
        const = instance == "auto" and const_taps_instance(spec, variant, directions)
        vec = stream_vector_copy(prev_primary, primary, w, bw)
        lib = _lib("edge_stream")
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.repro_stream_launch(
                *_geometry(x, rgb, n, h, w, bh, bw, spec, variant, directions, padding,
                           out_nms),
                int(const), mask.data_ptr(), prev_primary.data_ptr(), prev_bmax.data_ptr(),
                primary.data_ptr(), bmax.data_ptr(), int(vec),
                _claim_counter(x.device, stream).data_ptr(), stream,
            )
        _raise_on_error(lib, "edge_stream", err)
        edge_stream_cuda.launches += 1
        edge_stream_cuda.vector_launches += int(vec)
    return primary, bmax


edge_stream_cuda.launches = 0
edge_stream_cuda.vector_launches = 0


_claims: dict = {}


def _claim_counter(device: torch.device, stream: int) -> torch.Tensor:
    """K3's work counter for launches on ``stream`` (two zeroed int64 that
    every launch leaves zeroed: its last CTA resets them), made once per
    device and stream by a copy from the host, never by a kernel."""
    key = (device.index, stream)
    counter = _claims.get(key)
    if counter is None:
        counter = _claims[key] = torch.zeros(2, dtype=torch.int64).to(device)
    return counter
