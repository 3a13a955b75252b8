"""Spatial partitioning of frames across devices with halo exchange.

The port of ``repro.sharding.halo``. A frame too big for one device is
split into ``rows x cols`` spatial bands over the image mesh ``(data, row,
col)`` (``repro_torch.runtime.elastic.ImageMesh``), and each device
computes its band with a halo of the operator's radius copied from its
neighbours: the device-level counterpart of the halo window each CTA
stages in shared memory (``kernels/tiling.py``).

The reference maps a function over a JAX ``Mesh`` and moves the halos with
``ppermute``. The port is single-controller too: one process walks the
grid, copies each neighbour's boundary rows into the shard's device
(``narrow`` + ``.to``), launches the per-shard engine on each
halo-extended block and gathers the cropped blocks on the mesh's first
device. The per-image peak is a max over the shards' peaks (``pmax``).

Exactness contract: the per-shard outputs are bit-identical to the
single-device engine, by the reference's construction:

  * Interior shard edges: each neighbour's ``r`` boundary rows, then
    columns of the row-extended block (so a corner comes from the diagonal
    neighbour in two hops). The shards at the mesh ends receive zeros.
  * Global image edges: the first shard rebuilds its leading halo from its
    own rows with the index map the kernels use
    (``tiling.boundary_index``); under ``zero`` padding it stays zero. The
    last shard's trailing halo stays zero: no valid output reads it.
  * Ragged shapes: a dimension is extended, before it is split, with the
    boundary rule's extension values (:func:`extend_axis`), to
    ``parts * ceil((n + r) / parts)`` (:func:`shard_geometry`), so every
    valid output pixel reads only image or extension values; the per-shard
    kernel's own boundary rule touches only halo outputs, which are
    cropped away.
  * The peak: per shard the max of the un-thinned magnitude over its valid
    pixels, then the max over shards; both propagate NaN.

The exchange keeps the dtype (u8 stays u8), so the per-shard engine sees
what the single-device one would: u8 gray goes to K1's integer lane and
RGB's luma is taken per shard. With distinct devices (``cuda:0..N``) the
same code copies between cards; that path has not run on a one-card
machine.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.tiling import PAD_MODES, boundary_index, window_radius
from repro_torch.runtime.elastic import (
    ImageMesh,
    make_image_mesh,
    plan_image_mesh,
    visible_devices,
)

__all__ = [
    "ShardConfig",
    "shard_geometry",
    "extend_axis",
    "exchange_radius",
    "halo_exchange",
    "sharded_edge",
    "exchange",
    "gather",
    "ShardedBlocks",
    "mesh_from_config",
]


@dataclasses.dataclass(frozen=True)
class ShardConfig:
    """How to spread one edge-detection call over the image mesh.

    Fields:
      data: batch-axis shards (frames per device group); 0 = auto: fill
            whatever devices the spatial grid leaves over.
      rows: spatial row bands per frame (halo exchange along ``row``).
      cols: spatial column bands per frame (halo exchange along ``col``).

    ``ShardConfig()`` (all defaults) on a multi-device host means pure
    batch parallelism over every device. Hashable, like
    :class:`repro_torch.api.EdgeConfig` itself.
    """

    data: int = 0
    rows: int = 1
    cols: int = 1

    @classmethod
    def auto(cls) -> "ShardConfig":
        """Fill all local devices with batch parallelism."""
        return cls(data=0, rows=1, cols=1)

    @classmethod
    def parse(cls, text: str) -> "ShardConfig":
        """``"DxRxC"`` (e.g. ``"2x2x2"``, ``0`` = auto-fill data) or
        ``"auto"``."""
        text = text.strip().lower()
        if text in ("auto", ""):
            return cls.auto()
        parts = text.split("x")
        if len(parts) != 3:
            raise ValueError(
                f"shard spec {text!r} must be 'DxRxC' (e.g. '2x2x2') or 'auto'"
            )
        d, r, c = (int(p) for p in parts)
        return cls(data=d, rows=r, cols=c)

    def resolve(self, n_devices: int) -> Tuple[int, int, int]:
        """Concrete (data, rows, cols) for ``n_devices``; raises if the
        explicit request does not fit. Only ``data`` may be 0 (= auto)."""
        if self.rows < 1 or self.cols < 1 or self.data < 0:
            raise ValueError(
                f"invalid shard config {self.data}x{self.rows}x{self.cols}: "
                "rows/cols must be >= 1 (only data may be 0 = auto-fill)"
            )
        if self.rows * self.cols > n_devices:
            raise ValueError(
                f"spatial grid {self.rows}x{self.cols} needs "
                f"{self.rows * self.cols} devices, have {n_devices}"
            )
        (d, r, c), _ = plan_image_mesh(
            n_devices, rows=self.rows, cols=self.cols, data=self.data
        )
        if self.data and d != self.data:
            raise ValueError(
                f"shard config {self.data}x{self.rows}x{self.cols} needs "
                f"{self.data * self.rows * self.cols} devices, have {n_devices}"
            )
        return d, r, c


def mesh_from_config(shard: ShardConfig, devices: Optional[Sequence] = None) -> ImageMesh:
    """Image mesh for a :class:`ShardConfig` over ``devices`` (default: every
    visible CUDA device); raises when the request does not fit them."""
    devices = [torch.device(d) for d in devices] if devices is not None else visible_devices()
    d, r, c = shard.resolve(len(devices))
    return make_image_mesh(devices, rows=r, cols=c, data=d)


# ---------------------------------------------------------------------------
# Shard geometry and the materialized boundary extension
# ---------------------------------------------------------------------------

def exchange_radius(spec, nms: bool = False, *, plan=None) -> int:
    """Halo-exchange width (px) for one fused step of ``spec``: the rule
    that sizes the kernel's window (:func:`tiling.window_radius`). A
    multi-stage ``plan`` composes every linear stage's radius
    (``plan.linear_reach``) plus the NMS ring, so one exchange covers the
    whole fused chain."""
    if plan is not None:
        return window_radius(plan.linear_reach, nms or plan.nms)
    return window_radius(spec.radius, nms)


def shard_geometry(n: int, parts: int, radius: int) -> Tuple[int, int]:
    """(shard, padded_total) for one spatial dim split into ``parts``.

    Unsharded dims pass through. Sharded dims are padded up to
    ``parts * shard`` with ``shard = ceil((n + radius) / parts)``: always
    at least ``radius`` rows of slack past the true edge, so a valid output
    pixel never reads past the materialized extension into the last
    shard's zero halo.
    """
    if parts <= 1:
        return n, n
    shard = -(-(n + radius) // parts)
    return shard, shard * parts


def extend_axis(x: torch.Tensor, axis: int, n: int, total: int, padding: str) -> torch.Tensor:
    """Extend ``x`` from ``n`` to ``total`` along ``axis`` with the boundary
    rule's extension values (the index map the kernels apply, so the pad
    is bit-identical to what the single-device kernel reads there)."""
    if total == n:
        return x
    if padding == "zero":
        shape = list(x.shape)
        shape[axis] = total - n
        return torch.cat([x, x.new_zeros(shape)], dim=axis)
    g = torch.arange(n, total, device=x.device)
    return torch.cat([x, x.index_select(axis, boundary_index(g, n, padding))], dim=axis)


# ---------------------------------------------------------------------------
# Halo exchange
# ---------------------------------------------------------------------------

def halo_exchange(
    blocks: Sequence[torch.Tensor],
    radius: int,
    padding: str,
    *,
    axis: int,
    n_global: int,
) -> List[torch.Tensor]:
    """One spatial dim of halo exchange over the ``parts = len(blocks)``
    bands of one mesh line, in order: grow each block by ``radius`` on
    both sides along ``axis``.

    Interior halos are the neighbours' boundary rows, copied into the
    block's device (the reference's two non-cyclic ``ppermute`` shifts).
    The first block's leading halo is rebuilt from its own rows by the
    boundary rule (zeros under ``zero``); the last block's trailing halo
    stays zero: by construction (:func:`shard_geometry`) no valid output
    reads it.
    """
    parts = len(blocks)
    if parts <= 1:
        return list(blocks)
    if padding not in PAD_MODES:
        raise ValueError(f"unknown padding {padding!r}; expected one of {PAD_MODES}")
    out = []
    for k, x in enumerate(blocks):
        zeros_shape = list(x.shape)
        zeros_shape[axis] = radius
        if k > 0:
            prev = blocks[k - 1]
            lead = prev.narrow(axis, prev.shape[axis] - radius, radius).to(x.device)
        elif padding == "zero":
            lead = x.new_zeros(zeros_shape)
        else:
            src = boundary_index(torch.arange(-radius, 0, device=x.device), n_global, padding)
            lead = x.index_select(axis, src)
        if k < parts - 1:
            trail = blocks[k + 1].narrow(axis, 0, radius).to(x.device)
        else:
            trail = x.new_zeros(zeros_shape)
        out.append(torch.cat([lead, x, trail], dim=axis))
    return out


# ---------------------------------------------------------------------------
# The sharded engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedBlocks:
    """The halo-extended blocks of one batch, ``blocks[g][i][j]`` on
    ``mesh.devices[g][i][j]``, and the geometry that crops them back:
    ``b, h, w`` the batch and frame, ``sh, sw`` a shard's kept extent, ``t,
    l`` its leading halo after the exchange."""

    blocks: List[List[List[torch.Tensor]]]
    mesh: ImageMesh
    b: int
    h: int
    w: int
    sh: int
    sw: int
    t: int
    l: int  # noqa: E741


def exchange(x: torch.Tensor, mesh: ImageMesh, *, radius: int, padding: str,
             rgb: bool = False) -> ShardedBlocks:
    """The first step of :func:`sharded_edge`: extend ``x`` by the boundary
    rule, pad the batch to a multiple of ``data``, scatter each shard's
    block to its device and exchange the halos, rows then columns."""
    d, rr, cc = mesh.shape["data"], mesh.shape["row"], mesh.shape["col"]
    b = x.shape[0]
    h, w = (x.shape[-3], x.shape[-2]) if rgb else (x.shape[-2], x.shape[-1])

    sh, hp = shard_geometry(h, rr, radius)
    sw, wp = shard_geometry(w, cc, radius)
    for name, parts, shard in (("rows", rr, sh), ("cols", cc, sw)):
        if parts > 1 and shard < radius + 1:
            raise ValueError(
                f"{name}={parts} leaves spatial shards of {shard} pixels — "
                f"too small for operator radius {radius}; use a coarser "
                "spatial grid for this image"
            )

    # Materialize the extension values (ragged pad) and round the batch up.
    bp = -(-b // d) * d
    if bp != b:
        x = torch.cat([x, x.new_zeros((bp - b,) + tuple(x.shape[1:]))], dim=0)
    x = extend_axis(x, 1, h, hp, padding)
    x = extend_axis(x, 2, w, wp, padding)

    bl = bp // d
    blocks = []
    for g in range(d):
        xg = x[g * bl:(g + 1) * bl]
        devs = mesh.devices[g]
        grid = [[xg[:, i * sh:(i + 1) * sh, j * sw:(j + 1) * sw].to(devs[i][j])
                 for j in range(cc)] for i in range(rr)]
        for j in range(cc):           # rows first ...
            band = halo_exchange([grid[i][j] for i in range(rr)], radius, padding,
                                 axis=1, n_global=h)
            for i in range(rr):
                grid[i][j] = band[i]
        for i in range(rr):           # ... then columns of the row-extended blocks
            grid[i] = [blk.contiguous() for blk in
                       halo_exchange(grid[i], radius, padding, axis=2, n_global=w)]
        blocks.append(grid)
    return ShardedBlocks(blocks, mesh, b, h, w, sh, sw,
                         radius if rr > 1 else 0, radius if cc > 1 else 0)


def gather(parts: ShardedBlocks, outs, *, need_comps: bool = False, need_peak: bool = False):
    """The last step of :func:`sharded_edge`: crop each shard's ``(primary,
    comps, raw)`` to its kept extent, take its peak over its valid pixels
    and assemble the batch on the mesh's first device."""
    b, h, w, sh, sw, t, l = parts.b, parts.h, parts.w, parts.sh, parts.sw, parts.t, parts.l
    lead = parts.mesh.lead
    mags, comps_out, peaks = [], [], []
    for grid in outs:
        mag_rows, comp_rows, peak = [], [], None
        for i, row in enumerate(grid):
            mag_row, comp_row = [], []
            for j, (mag, comps, raw) in enumerate(row):
                mag = mag[:, t:t + sh, l:l + sw]
                mag_row.append(mag.to(lead))
                if need_comps:
                    comp_row.append(comps[:, :, t:t + sh, l:l + sw].to(lead))
                if need_peak:
                    src = raw[:, t:t + sh, l:l + sw] if raw is not None else mag
                    # The max over the valid pixels; a shard of padding alone
                    # gives 0, which is exact: the magnitude is >= 0.
                    vh, vw = min(sh, h - i * sh), min(sw, w - j * sw)
                    if vh > 0 and vw > 0:
                        p = src[:, :vh, :vw].amax(dim=(1, 2)).to(lead)
                    else:
                        p = torch.zeros(src.shape[0], dtype=src.dtype, device=lead)
                    peak = p if peak is None else torch.maximum(peak, p)
            mag_rows.append(torch.cat(mag_row, dim=2))
            if need_comps:
                comp_rows.append(torch.cat(comp_row, dim=3))
        mags.append(torch.cat(mag_rows, dim=1))
        if need_comps:
            comps_out.append(torch.cat(comp_rows, dim=2))
        if need_peak:
            peaks.append(peak)

    # Contiguous, as the single-device outputs are: a strided view would
    # send elementwise ops (atan2 for the orientation) down another loop.
    mag = torch.cat(mags, dim=0)[:b, :h, :w].contiguous()
    comps = torch.cat(comps_out, dim=0)[:b, :, :h, :w].contiguous() if need_comps else None
    peak = torch.cat(peaks, dim=0)[:b] if need_peak else None
    return mag, comps, peak


def sharded_edge(
    x: torch.Tensor,
    mesh: ImageMesh,
    *,
    radius: int,
    padding: str,
    compute: Callable[[torch.Tensor], Tuple[torch.Tensor, Optional[torch.Tensor],
                                            Optional[torch.Tensor]]],
    rgb: bool = False,
    need_comps: bool = False,
    need_peak: bool = False,
    chaos=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Run a per-shard edge compute over the image mesh, bit-exact with the
    single-device engine: :func:`exchange`, one ``compute`` per shard,
    :func:`gather`.

    Args:
      x: ``(B, H, W)`` gray or ``(B, H, W, 3)`` RGB batch (u8/f32).
      mesh: an :class:`~repro_torch.runtime.elastic.ImageMesh`.
      radius: the halo width, :func:`exchange_radius`.
      padding: boundary rule; it also governs the fix-up at global edges.
      compute: the per-shard single-device engine: takes the halo-extended
        block ``(B_loc, h_ext, w_ext[, 3])`` on its device and returns
        ``(primary, components or None, raw magnitude or None)``, the
        components shaped ``(B_loc, D, h_ext, w_ext)``. ``primary`` is the
        magnitude or the NMS thin map; in the latter case the third element
        is the un-thinned magnitude, the peak's source.
      need_comps / need_peak: which extras to assemble.
      chaos: optional ``repro_torch.runtime.chaos.FaultPlan``; fires the
        ``"halo.sharded_edge"`` site before any mesh work.

    Returns ``(primary (B, H, W), components (B, D, H, W) | None, peak (B,)
    | None)`` on the mesh's first device; the peak is the exact per-image
    max of the un-normalized magnitude over valid pixels.
    """
    if chaos is not None:
        chaos.fire("halo.sharded_edge")
    parts = exchange(x, mesh, radius=radius, padding=padding, rgb=rgb)
    outs = [[[compute(blk) for blk in row] for row in grid] for grid in parts.blocks]
    return gather(parts, outs, need_comps=need_comps, need_peak=need_peak)
