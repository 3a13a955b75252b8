"""Contract rules for the port's fused edge engine.

Each ``check_*`` function takes an observed artifact of the engine and
returns a list of :class:`~repro_torch.analysis.violations.Violation`.
The reference walks jaxprs and TPU StableHLO; the port observes what its
engine really runs:

* on the CPU, eager traces of the ``torch`` lane (``analysis.trace``:
  aten ops, plain-lane calls, impulse reach), the operator specs and
  plans, the shared-memory models of ``kernels/edge.py``, the build flags
  and the CUDA sources;
* on the card, the ``cuda`` lane's aten ops and launch counters, the
  device activity the profiler records, and the compiled K1-K3 themselves
  (``analysis.device``: the PTX and SASS of the built libraries).

The rule ids, names and order are the reference's (``repro.analysis.rules``);
each ``guards`` text says what the port checks and where its form differs.
The committed baseline (``analysis_baseline_torch.json``) keys off
``RULE|location``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.analysis.trace import OpTrace
from repro_torch.analysis.violations import Violation
from repro_torch.core.ladder import tap_accumulation_bounds

__all__ = [
    "RULES",
    "Rule",
    "AnalysisError",
    "RingProgram",
    "check_fusion_purity",
    "check_kernel_cardinality",
    "check_device_program",
    "check_contraction_fences",
    "check_dtype_ladder",
    "check_kernel_accum_dtype",
    "check_dma_pipeline",
    "check_vmem_budget",
    "check_launch_smem",
    "check_halo_window",
    "check_static_registration",
    "tap_accumulation_bounds",
]


class AnalysisError(RuntimeError):
    """The analyzer itself was misused or could not observe what a rule
    needs (a missing tool, an empty listing, bad geometry) — distinct from
    a rule violation in the analyzed program. The CLI exits 2 on it."""


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    name: str
    guards: str
    since: str


RULES: Dict[str, Rule] = {
    r.id: r
    for r in [
        Rule(
            "FUSE001",
            "fusion-purity",
            "no pad/slice/select/unbind/cat/index staging among the aten ops a "
            "call runs around its kernel: on the card every op of one "
            "backend='cuda' call (a launch is no aten op), on the CPU every op "
            "of a backend='torch' call outside the plain lane's body, which is "
            "opaque as the reference's kernel bodies are; the component "
            "unstack and the hysteresis fixpoint stay scoped allowances",
            "repro.analysis",
        ),
        Rule(
            "FUSE002",
            "kernel-cardinality",
            "exactly one kernel launch per fused call (gray→gradient→NMS stay "
            "one kernel), counted by the wrappers' counters on the card (K1, "
            "K2 or K3; one a shard on a mesh) and as plain-lane calls on the "
            "CPU",
            "repro.analysis",
        ),
        Rule(
            "FUSE003",
            "mosaic-purity",
            "the device program of one facade call is exactly one edge kernel "
            "with no pad, copy, cat, index, memcpy or memset activity beside "
            "it (the profiler's record on the card; the port's form of the "
            "reference's one-tpu_custom_call export check); needs the card",
            "repro.analysis",
        ),
        Rule(
            "FMA001",
            "contraction-safety",
            "no fused multiply-add in the edge kernels: the build flags keep "
            "--fmad=false and none of --use_fast_math, -ftz=true, "
            "--prec-div=false, --prec-sqrt=false; csrc/edge*.cu{,h} call no "
            "fmaf/__fma*; on the card no fma.rn.f32 in the PTX of any K1-K3 "
            "instance (SASS FFMA is IEEE sqrtf's and division's own "
            "expansion, so it is counted, not judged)",
            "repro.analysis",
        ),
        Rule(
            "DTYPE001",
            "dtype-ladder",
            "u8 input × integer taps accumulates exactly in f32 (≤ 2^24), and "
            "no integer lane accumulates narrower than the ladder licenses "
            "(core.ladder.accum_dtype): the plain lane's traced u8→int cast "
            "is the narrowest licensed; each integer-lane kernel instance's "
            "accumulator (from its mangled name) holds the licensed bound — "
            "32-bit is the accumulate width of the card's integer pipes, so "
            "i16-licensed operators run in i32 there (listed as a finding)",
            "repro.analysis",
        ),
        Rule(
            "PIPE001",
            "dma-pipeline",
            "K2 runs a well-formed ring: copies issued (TMA or cp.async) AND "
            "mbarrier waits, depth ≥ 2 and one mbarrier a slot, for every "
            "depth tile_fits allows (the ring model of kernels/edge.py and "
            "K2's source on the CPU, the copy and try-wait instructions of "
            "each K2 instance's SASS on the card)",
            "repro.analysis",
        ),
        Rule(
            "VMEM001",
            "vmem-budget",
            "a tile's shared memory (edge.window_smem_bytes, K2's "
            "pipelined_smem_bytes) fits SMEM_MAX (232,448 B) for the default "
            "tile, every legal tile and the plans; on the card the dynamic "
            "shared memory each launch asks for equals the kernels' "
            "allocation model (edge.launch_smem_bytes) and fits the card's "
            "opt-in maximum",
            "repro.analysis",
        ),
        Rule(
            "HALO001",
            "halo-consistency",
            "the reach an impulse probe measures on the lane (impulses at "
            "0..R+1 from a tile border) equals tiling.window_radius "
            "(OperatorSpec.radius, or a plan's linear_reach, +1 under NMS) "
            "equals halo.exchange_radius; K2's ring slot holds that window",
            "repro.analysis",
        ),
        Rule(
            "DET001",
            "no-wall-clock-or-randomness",
            "kernel-math modules import no time/random/uuid/secrets and "
            "call no RNG — a rerun must be reproducible",
            "repro.analysis",
        ),
        Rule(
            "DET002",
            "no-python-branch-on-tracer",
            "no Python if/while/assert/bool() on a torch tensor expression in "
            "kernel-math modules — on the card each is a device→host sync; "
            "static shape, dtype and device queries stay allowed",
            "repro.analysis",
        ),
        Rule(
            "DET003",
            "static-pytrees-hashable",
            "the frozen dataclasses the port keys caches on (OperatorSpec, "
            "EdgeConfig, StencilPlan, Stage) stay frozen and hashable; "
            "register_static targets in source are frozen dataclasses",
            "repro.analysis",
        ),
    ]
}

# Aten ops that stage data around a fused kernel (FUSE001). View ops count
# too: the reference flags every slice, and a view that a later op copies
# is a staging pass.
_PAD_OPS = ("constant_pad_nd", "reflection_pad1d", "reflection_pad2d", "reflection_pad3d",
            "replication_pad1d", "replication_pad2d", "replication_pad3d", "pad")
_SLICE_OPS = ("slice", "select", "unbind", "narrow", "split", "split_with_sizes")
_STAGING_OPS = _PAD_OPS + _SLICE_OPS + (
    "cat", "stack", "index", "index_select", "gather", "take", "index_put", "index_put_",
    "scatter", "scatter_")

# Scopes whose ops FUSE001 skips: the plain lane's kernel bodies.
PLAIN_LANE = ("edge_plain", "edge_stream_plain")


def _is_component_unstack(op) -> bool:
    """A view that peels direction planes off the stacked component axis of
    an (N, D, H, W) output: ``unbind(1)``, ``select(1, d)`` or a slice of
    one plane. The only HBM-level slicing the fused engine performs, in
    the with_components / with_orientation output modes."""
    if op.packet not in ("unbind", "select", "slice") or not op.in_shapes:
        return False
    src = op.in_shapes[0]
    if len(src) != 4 or src[1] <= 1 or op.dim not in (1, -3):
        return False
    if op.packet == "slice":
        return bool(op.out_shapes) and op.out_shapes[0] == (src[0], 1) + tuple(src[2:])
    return True


def check_fusion_purity(
    trace: OpTrace,
    *,
    location: str,
    allow_unstack: bool = False,
    opaque: Sequence[str] = PLAIN_LANE,
) -> List[Violation]:
    """FUSE001: no data-prep staging ops among the call's aten ops.

    Ops whose ``scope`` is in ``opaque`` are skipped: the plain lane's
    bodies (``PLAIN_LANE``), and in hysteresis mode ``"hysteresis"``,
    whose linking fixpoint dilates with slices *by design* (it runs after
    the kernel, on the gathered thin map).
    """
    hits: Dict[str, int] = {}
    for op in trace.ops:
        if op.scope in opaque or op.packet not in _STAGING_OPS:
            continue
        if allow_unstack and _is_component_unstack(op):
            continue
        hits[op.packet] = hits.get(op.packet, 0) + 1
    return [
        Violation(
            "FUSE001",
            location,
            f"{n} HBM-level `{name}` op(s) in a fused path",
            detail=(("primitive", name), ("count", str(n))),
        )
        for name, n in sorted(hits.items())
    ]


def check_kernel_cardinality(
    launches: int, *, location: str, expected: int = 1, unit: str = "kernel launch"
) -> List[Violation]:
    """FUSE002: a fused call launched exactly ``expected`` kernels
    (``unit`` names what was counted: launches on the card, plain-lane
    calls on the CPU)."""
    if launches == expected:
        return []
    return [
        Violation(
            "FUSE002",
            location,
            f"{launches} {unit}(es), expected {expected}",
            detail=(("launches", str(launches)), ("expected", str(expected))),
        )
    ]


_DEVICE_STAGING = re.compile(r"pad|copy|\bcat\b|index|gather|scatter|memcpy|memset", re.I)


def check_device_program(
    activities: Sequence[str], *, location: str, kernel: str
) -> List[Violation]:
    """FUSE003: the device activity of one call (kernel names, and
    memcpy/memset records, from the profiler) holds exactly one launch of
    ``kernel`` (``edge_kernel``, ``pipelined_kernel`` or ``stream_kernel``)
    and no pad, copy, cat, index, gather, scatter, memcpy or memset
    activity. Epilogue kernels (the peak's reduction, the normalize
    multiply) are not staging and pass."""
    if not activities:
        raise AnalysisError(f"{location}: the profiler recorded no device activity")
    out: List[Violation] = []
    ours = [a for a in activities if re.search(rf"\b{kernel}<", a)]
    if len(ours) != 1:
        out.append(
            Violation(
                "FUSE003",
                location,
                f"{len(ours)} {kernel} launch(es) in the call's device program, expected 1",
                detail=(("kernel", kernel), ("launches", str(len(ours)))),
            )
        )
    staging: Dict[str, int] = {}
    for a in activities:
        if a in ours:
            continue
        m = _DEVICE_STAGING.search(a)
        if m:
            key = m.group(0).lower()
            staging[key] = staging.get(key, 0) + 1
    for key, n in sorted(staging.items()):
        out.append(
            Violation(
                "FUSE003",
                location,
                f"{n} device {key} activit(ies) beside the edge kernel",
                detail=(("op", key), ("count", str(n))),
            )
        )
    return out


# Flags that would let the compiler contract or approximate (FMA001).
_FORBIDDEN_FLAGS = ("--use_fast_math", "-use_fast_math", "-ftz=true", "--ftz=true",
                    "--prec-div=false", "-prec-div=false", "--prec-sqrt=false",
                    "-prec-sqrt=false", "--fmad=true", "-fmad=true")
_FMA_CALL = re.compile(r"\b(?:fmaf|fma|__fmaf_\w+|__fma_\w+)\s*\(")
_PTX_FMA = re.compile(r"\bfma\.rn(?:\.ftz)?(?:\.sat)?\.f32\b")


def check_contraction_fences(
    *,
    location: str,
    flags: Optional[Sequence[str]] = None,
    sources: Optional[Mapping[str, str]] = None,
    ptx: Optional[Mapping[str, str]] = None,
) -> List[Violation]:
    """FMA001: nothing contracts a product into its sum.

    ``flags``: the nvcc command line must hold ``--fmad=false`` and none of
    the fast-math flags. ``sources``: path → CUDA source text; no call of
    ``fmaf``/``fma``/``__fmaf_*``/``__fma_*``. ``ptx``: function → its PTX
    body (the compiled program, ``analysis.device``); no ``fma.rn.f32``.
    The location of a source or PTX hit is ``path:line`` or the function.
    """
    out: List[Violation] = []
    if flags is not None:
        flat = " ".join(flags).split()
        if "--fmad=false" not in flat and "-fmad=false" not in flat:
            out.append(
                Violation(
                    "FMA001",
                    location,
                    "nvcc flags lack --fmad=false: the compiler may contract "
                    "a product and its sum into one FMA",
                    detail=(("flag", "--fmad=false"),),
                )
            )
        for f in flat:
            if f in _FORBIDDEN_FLAGS:
                out.append(
                    Violation(
                        "FMA001",
                        location,
                        f"nvcc flag {f} relaxes IEEE rounding",
                        detail=(("flag", f),),
                    )
                )
    for path, text in sorted((sources or {}).items()):
        for lineno, line in enumerate(text.splitlines(), start=1):
            code = line.split("//", 1)[0]
            m = _FMA_CALL.search(code)
            if m:
                out.append(
                    Violation(
                        "FMA001",
                        f"{path}:{lineno}",
                        f"explicit fused multiply-add `{m.group(0).rstrip('( ')}` "
                        "in kernel source",
                        detail=(("call", m.group(0).rstrip("( ")),),
                    )
                )
    for fn, body in sorted((ptx or {}).items()):
        n = len(_PTX_FMA.findall(body))
        if n:
            out.append(
                Violation(
                    "FMA001",
                    f"{location}/{fn}",
                    f"{n} fma.rn.f32 instruction(s) in the compiled PTX",
                    detail=(("fma.rn.f32", str(n)),),
                )
            )
    return out


def check_dtype_ladder(spec, *, location: str) -> List[Violation]:
    """DTYPE001 (spec half): integer-tap operators must accumulate u8
    input exactly in f32 (all intermediates ≤ 2^24) — the contract both
    arithmetic lanes rely on: it is what makes the integer lane
    bit-identical to the f32 lane by construction."""
    b = tap_accumulation_bounds(spec)
    if not b["integer_taps"]:
        return []  # fractional taps opt out of the integer ladder
    if b["f32_exact"]:
        return []
    return [
        Violation(
            "DTYPE001",
            location,
            f"integer-tap accumulation bound {b['worst']:.0f} exceeds the "
            f"f32-exact integer range (2^24); i16={b['fits_i16']}, "
            f"i32={b['fits_i32']}",
            detail=(
                ("worst", f"{b['worst']:.0f}"),
                ("fits_i16", str(b["fits_i16"])),
                ("fits_i32", str(b["fits_i32"])),
            ),
        )
    ]


_WIDTH = {"int16": 16, "int32": 32}


def _traced_accumulators(trace: OpTrace) -> List[str]:
    """Signed integer dtypes a traced call casts u8 arrays (rank ≥ 2) to:
    the integer lane's entry (``core.sobel.to_lane``)."""
    seen: List[str] = []
    for op in trace.ops:
        if op.packet not in ("_to_copy", "to") or not op.in_dtypes or not op.out_dtypes:
            continue
        if op.in_dtypes[0] != "uint8" or len(op.out_shapes[0]) < 2:
            continue
        d = op.out_dtypes[0]
        if d.startswith("int") and d not in seen:
            seen.append(d)
    return seen


def check_kernel_accum_dtype(found, *, location: str, spec, plan=None) -> List[Violation]:
    """DTYPE001 (kernel half): no integer lane accumulates narrower than
    the ladder licenses (``core.ladder.accum_dtype``; with ``plan``,
    ``plan_accum_dtype``).

    ``found`` is an :class:`~repro_torch.analysis.trace.OpTrace` (the plain
    lane's u8→int entry casts are read from it) or the accumulator dtype
    names of the kernel instances that serve ``spec`` (``analysis.device``).
    No integer accumulation passes vacuously. Narrower than licensed — i16
    where the bound needs i32 — is the silent wraparound this rule
    catches; wider stays exact and passes; a dtype no proof covers fails.
    """
    from repro_torch.core import ladder

    seen = _traced_accumulators(found) if isinstance(found, OpTrace) else list(found)
    if not seen:
        return []
    expected = ladder.plan_accum_dtype(plan) if plan is not None else ladder.accum_dtype(spec)
    if expected is None:
        return [
            Violation(
                "DTYPE001",
                location,
                f"integer accumulation ({', '.join(seen)}) in a trace of "
                f"operator {spec.name!r}, which has no proven integer "
                "budget (fractional taps or bound beyond 2^24)",
                detail=(("found", ",".join(seen)), ("expected", "none")),
            )
        ]
    return [
        Violation(
            "DTYPE001",
            location,
            f"kernel accumulates u8 taps in {d}, but the ladder proof "
            f"licenses {expected} for operator {spec.name!r}"
            + ("" if d in _WIDTH else " (no proof covers this dtype)"),
            detail=(("found", d), ("expected", expected)),
        )
        for d in seen
        if d not in _WIDTH or _WIDTH[d] < _WIDTH[expected]
    ]


@dataclasses.dataclass(frozen=True)
class RingProgram:
    """What PIPE001 reads of K2: its ring ``depth``, the ``barriers`` its
    shared-memory layout holds, and how many copy-issue and wait sites (or
    SASS instructions) its program has."""

    depth: int
    barriers: int
    copies: int
    waits: int


def check_dma_pipeline(ring: RingProgram, *, location: str, min_depth: int = 2) -> List[Violation]:
    """PIPE001: a launch that requests a ring depth runs a well-formed ring:
    copies issued AND waited on, depth ≥ ``min_depth`` (double buffering
    needs two slots), and one mbarrier per slot so each copy has a
    slot-matched wait."""
    if not ring.copies:
        return [
            Violation(
                "PIPE001",
                location,
                "no copy issue (TMA or cp.async) in K2's program — a ring "
                "depth was requested but nothing fills the ring",
                detail=(("copies", "0"),),
            )
        ]
    if not ring.waits:
        return [
            Violation(
                "PIPE001",
                location,
                f"{ring.copies} copy site(s) but no mbarrier wait — started "
                "copies are never consumed",
                detail=(("copies", str(ring.copies)), ("waits", "0")),
            )
        ]
    out: List[Violation] = []
    if ring.depth < min_depth:
        out.append(
            Violation(
                "PIPE001",
                location,
                f"ring depth {ring.depth} < {min_depth} — double buffering "
                "requires at least two slots",
                detail=(("depth", str(ring.depth)),),
            )
        )
    if ring.barriers != ring.depth:
        out.append(
            Violation(
                "PIPE001",
                location,
                f"{ring.barriers} mbarrier(s) for a depth-{ring.depth} ring — "
                "copies and waits cannot pair one-to-one per slot",
                detail=(("barriers", str(ring.barriers)), ("depth", str(ring.depth))),
            )
        )
    return out


def _r_in(radius: int, nms: bool, plan) -> int:
    from repro_torch.kernels.tiling import window_radius

    if plan is not None:
        return window_radius(plan.linear_reach, nms or plan.nms)
    return window_radius(radius, nms)


def check_vmem_budget(
    *,
    location: str,
    block_h: int,
    block_w: int,
    radius: int,
    nms: bool = False,
    channels: Optional[int] = None,
    budget: Optional[int] = None,
    plan=None,
    depth: int = 0,
    in_bytes: int = 4,
) -> List[Violation]:
    """VMEM001: the tile's shared memory fits the budget (``SMEM_MAX``, the
    most a CTA may opt into on an H100): K1's and K3's footprint
    (``edge.window_smem_bytes``: halo window, NMS buffers, a plan's
    composed window and plane), or at ``depth`` 2..8 K2's
    (``edge.pipelined_smem_bytes``: ring, offsets, window).

    With ``plan`` the window's radius is the composed reach of the stage
    chain (``plan.linear_reach``, +1 for a trailing NMS stage)."""
    from repro_torch.kernels import edge

    cap = edge.SMEM_MAX if budget is None else budget
    plan_nms = nms or (plan is not None and plan.nms)
    if depth:
        need = edge.pipelined_smem_bytes(block_h, block_w, radius, depth, in_bytes,
                                         channels or 1, plan_nms, plan=plan)
    else:
        need = edge.window_smem_bytes(block_h, block_w, radius, plan_nms, plan=plan)
    if need <= cap:
        return []
    r_in = _r_in(radius, nms, plan)
    return [
        Violation(
            "VMEM001",
            location,
            f"block ({block_h}, {block_w}) with r={r_in}"
            + (f" at ring depth {depth}" if depth else "")
            + f" needs {need} B of shared memory > {cap} B budget",
            detail=(("bytes", str(need)), ("budget", str(cap))),
        )
    ]


def check_launch_smem(
    *, location: str, dynamic: int, expected: int, optin: int
) -> List[Violation]:
    """VMEM001 (card half): the dynamic shared memory a launch asked for
    (the profiler's record, less the function's static shared memory)
    equals the allocation model and fits the card's opt-in maximum."""
    out: List[Violation] = []
    if dynamic != expected:
        out.append(
            Violation(
                "VMEM001",
                location,
                f"launch asked for {dynamic} B of dynamic shared memory, the "
                f"allocation model says {expected} B",
                detail=(("bytes", str(dynamic)), ("expected", str(expected))),
            )
        )
    if dynamic > optin:
        out.append(
            Violation(
                "VMEM001",
                location,
                f"launch asked for {dynamic} B of dynamic shared memory > the "
                f"card's opt-in maximum {optin} B",
                detail=(("bytes", str(dynamic)), ("budget", str(optin))),
            )
        )
    return out


def check_halo_window(
    *,
    location: str,
    spec,
    nms: bool,
    measured: Optional[Tuple[int, int]] = None,
    ring_window: Optional[Tuple[int, int]] = None,
    block: Optional[Tuple[int, int]] = None,
    plan=None,
) -> List[Violation]:
    """HALO001: the reach the lane really has equals
    ``window_radius(spec.radius, nms)`` (with ``plan``:
    ``window_radius(plan.linear_reach, nms or plan.nms)``), and the sharded
    halo exchange is sized identically.

    ``measured`` is ``(rows, cols)`` from
    :func:`~repro_torch.analysis.trace.impulse_reach`; ``ring_window`` the
    ``(eh, ew)`` window a K2 ring slot holds, which must be ``block`` plus
    the reach on every side.
    """
    from repro_torch.sharding import halo as halo_mod

    expected = _r_in(spec.radius if spec is not None else 0, nms, plan)
    src = (f"linear_reach={plan.linear_reach}, nms={nms or plan.nms}"
           if plan is not None else f"radius={spec.radius}, nms={nms}")
    out: List[Violation] = []
    if measured is not None and tuple(measured) != (expected, expected):
        out.append(
            Violation(
                "HALO001",
                location,
                f"kernel window reach {tuple(measured)} != window_radius({src}) = {expected}",
                detail=(("derived", str(tuple(measured))), ("expected", str(expected))),
            )
        )
    if ring_window is not None:
        want = (block[0] + 2 * expected, block[1] + 2 * expected)
        if tuple(ring_window) != want:
            out.append(
                Violation(
                    "HALO001",
                    location,
                    f"ring slot window {tuple(ring_window)} != block + 2 x "
                    f"window_radius({src}) = {want}",
                    detail=(("tile", str(tuple(ring_window))), ("expected", str(want))),
                )
            )
    exch = halo_mod.exchange_radius(spec, nms, plan=plan)
    if exch != expected:
        out.append(
            Violation(
                "HALO001",
                location,
                f"sharded exchange width {exch} != kernel window radius {expected}",
                detail=(("exchange", str(exch)), ("expected", str(expected))),
            )
        )
    return out


def check_static_registration(cls, *, location: str) -> List[Violation]:
    """DET003 (runtime half): a class the engine keys caches on must be a
    frozen dataclass — hashable and equal by value — or a cache keyed on it
    silently misses (or crashes on unhashable instances). The AST half of
    this rule (``repro_torch.analysis.ast_rules``) catches the same
    mistake in source without importing it."""
    out: List[Violation] = []
    params = getattr(cls, "__dataclass_params__", None)
    if params is None or not params.frozen:
        out.append(
            Violation(
                "DET003",
                location,
                f"{cls.__name__} is registered static but is not a frozen "
                "dataclass",
                detail=(("class", cls.__name__),),
            )
        )
    elif getattr(cls, "__hash__", None) is None:
        out.append(
            Violation(
                "DET003",
                location,
                f"{cls.__name__} is registered static but unhashable",
                detail=(("class", cls.__name__),),
            )
        )
    return out
