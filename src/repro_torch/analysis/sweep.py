"""Registry sweep for the port's kernel contract analyzer.

Enumerates operator × backend × padding × layout × output-mode combos (the
reference's ``MODES``), runs each through the public ``repro_torch.api``
surface at a small shape while recording its aten ops and launches
(``analysis.trace``), probes the lane's reach with impulses, and runs
every applicable rule from :mod:`repro_torch.analysis.rules`. Adds
spec-level checks (dtype ladder, the shared-memory budget of the default
and every legal tile, K2's ring at every depth that fits, static
registration) per operator, a multi-stage StencilPlan battery, a sharded
call, the build flags and CUDA sources, and the AST determinism scan
over the kernel-math sources.

Backends: ``torch`` (the plain lane, on the CPU) is the default; ``cuda``
(the kernels, on the card) adds the card half: the launches, the
device program of one facade call (FUSE003, the launch's shared memory),
the impulse probe on K1, K2 and K3, the compiled PTX and SASS of every
K1-K3 instance (``analysis.device``) and the FULL sobel-hd config at
4x2048x2048 through FUSE002, FUSE003 and VMEM001. The report's meta names
the backends covered and every rule, or half of one, that did not run.

Fast sweep (default): two operators, reflect padding. Full sweep
(``--all`` / ``full=True``): every registered operator, all paddings on
the plain/NMS paths, every registered plan, and on the card the device
program of every operator.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis import ast_rules, rules
from repro_torch.analysis.rules import AnalysisError
from repro_torch.analysis.trace import impulse_reach, trace_ops
from repro_torch.analysis.violations import Report, Violation

__all__ = ["analyze", "MODES", "kernel_math_files", "DEFAULT_OPERATORS",
           "DEFAULT_PLANS", "BACKENDS"]

# Trace geometry: >= 3 blocks per axis, so the impulse probe straddles an
# interior tile border (row 32, column 64) with room for the widest reach.
TRACE_SHAPE = (1, 64, 96)
TRACE_BLOCK = (16, 32)

# The device-program battery's geometry (the reference's export shape).
EXPORT_SHAPE = (1, 512, 640)
EXPORT_BLOCK = (64, 128)

DEFAULT_OPERATORS = ("sobel3", "sobel5")
DEFAULT_PLANS = ("canny5", "blur_sobel5")
BACKENDS = ("torch", "cuda")
PAD_MODES = ("reflect", "edge", "zero")

# Representative service resolutions for the default-block budget check.
SERVICE_SHAPES = ((512, 640), (1080, 1920), (2160, 3840))

# Launch counters of the edge kernels (FUSE002 on the card).
_KERNELS = {"k1": "edge_kernel", "k2": "pipelined_kernel", "k3": "stream_kernel"}


@dataclasses.dataclass(frozen=True)
class Mode:
    """One output mode of the engine and how the rules apply to it."""

    name: str
    config_kw: Tuple[Tuple[str, object], ...] = ()
    stream: bool = False
    unstack: bool = False  # FUSE001 component-unstack allowance
    opaque_while: bool = False  # hysteresis: post-gather fixpoint slices by design
    all_paddings: bool = False  # sweep every padding in full mode
    export: bool = False  # part of the device-program battery
    pipelined: bool = False  # ring depth requested: K2, PIPE001 applies
    gray_only: bool = False  # integer lane: RGB is ineligible by design

    def kw(self) -> Dict[str, object]:
        return dict(self.config_kw)


MODES: Dict[str, Mode] = {
    m.name: m
    for m in [
        Mode("plain", (), all_paddings=True, export=True),
        Mode("nms", (("nms", True),), all_paddings=True, export=True),
        Mode("components", (("with_components", True),), unstack=True),
        Mode("orientation", (("with_orientation", True),), unstack=True),
        Mode("hysteresis", (("hysteresis", True),), opaque_while=True),
        Mode("stream", (), stream=True),
        Mode("stream-nms", (("nms", True),), stream=True),
        Mode("pipelined", (("pipeline_depth", 2),), pipelined=True,
             export=True),
        Mode("lowprec", (("precision", "int"),), gray_only=True, export=True),
        # The ring feeding the integer lane, NMS fused.
        Mode("lowprec-pipelined",
             (("precision", "int"), ("pipeline_depth", 3), ("nms", True)),
             pipelined=True, gray_only=True, export=True),
    ]
}

# Kernel-math modules excluded from the determinism scan, with reasons.
_DET_EXCLUDE = {
    # The autotuner measures wall-clock on purpose; it feeds the cache,
    # never a kernel.
    "kernels/tuning.py",
    # The build runs nvcc on purpose (threads, subprocesses, compile
    # seconds); it compiles the kernels and computes nothing they compute.
    "kernels/build.py",
}

# The rule halves that need the card, reported as not run without it.
_CARD_HALVES = {
    "FUSE001": "the cuda lane's ops need the card",
    "FUSE002": "K1-K3's launch counters need the card",
    "FUSE003": "the device program needs the card",
    "FMA001": "the PTX of K1-K3 needs the card",
    "DTYPE001": "the kernel instances' accumulators need the card",
    "PIPE001": "K2's SASS needs the card",
    "VMEM001": "the launches' shared memory needs the card",
    "HALO001": "the impulse probe on K1-K3 needs the card",
}
_EXPORT_HALVES = ("FUSE003", "FMA001", "DTYPE001", "PIPE001", "VMEM001")


def _pkg() -> Path:
    import repro_torch

    return Path(repro_torch.__file__).resolve().parent


def kernel_math_files() -> List[Tuple[str, str]]:
    """(abspath, repo-relative path) of every kernel-math source file."""
    pkg = _pkg()
    out: List[Tuple[str, str]] = []
    for sub in ("core", "kernels"):
        for fn in sorted(os.listdir(pkg / sub)):
            rel = f"{sub}/{fn}"
            if fn.endswith(".py") and rel not in _DET_EXCLUDE:
                out.append((str(pkg / sub / fn), f"src/repro_torch/{rel}"))
    return out


def _all_port_files() -> List[Tuple[str, str]]:
    pkg = _pkg()
    return [(str(p), f"src/{p.relative_to(pkg.parent)}") for p in sorted(pkg.rglob("*.py"))]


def _edge_sources() -> Dict[str, str]:
    """repo-relative path -> text of the edge kernels' CUDA sources."""
    csrc = _pkg() / "kernels" / "csrc"
    return {f"src/repro_torch/kernels/csrc/{p.name}": p.read_text()
            for p in sorted(csrc.glob("edge*.cu*"))}


def _count(report: Report, rule: str, n: int = 1) -> None:
    report.checks += n
    counts = report.meta.setdefault("rule_checks", {})
    counts[rule] = counts.get(rule, 0) + n


def _launches() -> Dict[str, int]:
    from repro_torch.kernels import edge

    return {"k1": edge.edge_cuda.launches, "k2": edge.edge_pipelined_cuda.launches,
            "k3": edge.edge_stream_cuda.launches}


def _opaque(mode_opaque_while: bool):
    from repro_torch.core import nms
    from repro_torch.kernels import edge

    return (edge.edge_plain, edge.edge_stream_plain) + (
        (nms.hysteresis,) if mode_opaque_while else ())


def _run_traced(fn, *args, opaque, **kwargs):
    """``(trace, launches by kernel)`` of one call."""
    before = _launches()
    _out, trace = trace_ops(fn, *args, opaque=opaque, **kwargs)
    after = _launches()
    return trace, {k: after[k] - before[k] for k in after}


def _cardinality(report: Report, location: str, backend: str, trace, launched,
                 kernel: str, expected: int = 1) -> List[Violation]:
    """FUSE002: ``expected`` launches of ``kernel`` and none of another edge
    kernel on ``cuda``; ``expected`` plain-lane calls on ``torch``."""
    _count(report, "FUSE002")
    if backend == "torch":
        calls = sum(trace.calls.get(n, 0) for n in rules.PLAIN_LANE)
        return rules.check_kernel_cardinality(calls, location=location, expected=expected,
                                              unit="plain-lane call")
    out = rules.check_kernel_cardinality(launched[kernel], location=location,
                                         expected=expected, unit=f"{_KERNELS[kernel]} launch")
    others = sum(v for k, v in launched.items() if k != kernel)
    out += rules.check_kernel_cardinality(others, location=location, expected=0,
                                          unit="other edge kernel launch")
    return out


def _k3_primary(cfg, dev):
    """K3 (or its plain version) over every tile of a batch: the primary map."""
    from repro_torch.kernels import edge

    c = cfg.resolved()
    run = edge.edge_stream_cuda if dev.type == "cuda" else edge.edge_stream_plain

    def fn(xb):
        rgb = xb.ndim == 4
        n, h, w = xb.shape[:3]
        bh, bw = c.block_h, c.block_w
        gh, gw = -(-h // bh), -(-w // bw)
        zeros = torch.zeros((n, h, w), dtype=torch.float32, device=dev)
        bmax = torch.zeros((n, gh, gw), dtype=torch.float32, device=dev)
        mask = torch.ones((n, gh, gw), dtype=torch.int32, device=dev)
        primary, _ = run(xb.contiguous(), zeros, bmax, mask, spec=c.spec, variant=c.variant,
                         directions=c.directions, padding=c.padding, block_h=bh,
                         block_w=bw, rgb=rgb, out_nms=c.nms)
        return primary

    return fn


def _probe(report: Report, location: str, cfg, shape, dev, *, stream: bool, spec, nms: bool,
           plan=None, ring_window=None, block=TRACE_BLOCK) -> List[Violation]:
    """HALO001 on the lane ``cfg`` runs: the impulse probe across the tile
    border at block (2, 2), impulses at offsets 0..R+1."""
    from repro_torch import api
    from repro_torch.kernels.tiling import window_radius

    r = window_radius(plan.linear_reach, nms or plan.nms) if plan is not None else \
        window_radius(spec.radius, nms)
    if stream:
        fn = _k3_primary(cfg, dev)
    else:
        pcfg = cfg.replace(normalize=False)

        def fn(xb):
            return api.edge_detect(xb, pcfg, device=dev).magnitude
    measured = impulse_reach(fn, tuple(shape[1:]), border=(2 * block[0], 2 * block[1]),
                             offsets=r + 2, device=dev)
    _count(report, "HALO001")
    return rules.check_halo_window(location=location, spec=spec, nms=nms, measured=measured,
                                   ring_window=ring_window, block=block, plan=plan)


def _ring(depth: int, bh: int, bw: int, radius: int, nms: bool, in_bytes: int = 1,
          plan=None) -> rules.RingProgram:
    """K2's ring as the CPU sees it: the layout model (``edge.pipelined_layout``)
    and the copy and wait sites of ``csrc/edge_pipelined.cu``."""
    from repro_torch.analysis.device import k2_source_sites
    from repro_torch.kernels import edge

    layout = edge.pipelined_layout(bh, bw, radius, depth, in_bytes, 1, nms, plan=plan)
    copies, waits = k2_source_sites(
        (_pkg() / "kernels" / "csrc" / "edge_pipelined.cu").read_text())
    return rules.RingProgram(layout["slots"], layout["barriers"], copies, waits)


def _combo_violations(op: str, backend: str, padding: str, layout: str, mode: Mode,
                      report: Report, dev) -> List[Violation]:
    from repro_torch import api
    from repro_torch.core.filters import get_operator
    from repro_torch.kernels import edge

    location = f"{op}/{backend}/{padding}/{layout}/{mode.name}"
    cfg = api.EdgeConfig(operator=op, backend=backend, padding=padding,
                         block_h=TRACE_BLOCK[0], block_w=TRACE_BLOCK[1], **mode.kw())
    rgb = layout == "rgb"
    n, h, w = TRACE_SHAPE
    shape = (n, h, w, 3) if rgb else (n, h, w)
    x = torch.zeros(shape, dtype=torch.uint8, device=dev)
    spec = get_operator(op)
    nms = bool(mode.kw().get("nms") or mode.kw().get("hysteresis"))
    depth = int(mode.kw().get("pipeline_depth", 0))
    opaque = _opaque(mode.opaque_while)
    if mode.stream:
        state = api.StreamState.init(n, h, w, cfg, rgb=rgb, device=dev)
        trace, launched = _run_traced(api.edge_detect_stream, x, cfg, state, device=dev,
                                      opaque=opaque)
    else:
        trace, launched = _run_traced(api.edge_detect, x, cfg, device=dev, opaque=opaque)
    report.combos.append(location)
    kernel = "k3" if mode.stream else ("k2" if depth else "k1")
    out: List[Violation] = []
    out += rules.check_fusion_purity(
        trace, location=location, allow_unstack=mode.unstack,
        opaque=rules.PLAIN_LANE + (("hysteresis",) if mode.opaque_while else ()))
    _count(report, "FUSE001")
    out += _cardinality(report, location, backend, trace, launched, kernel)
    if not mode.stream or backend == "cuda":
        ring = None
        if depth:
            lay = edge.pipelined_layout(*TRACE_BLOCK, spec.radius, depth, 1, 1, nms)
            ring = (lay["eh"], lay["ew"])
        out += _probe(report, location, cfg, shape, dev, stream=mode.stream, spec=spec,
                      nms=nms, ring_window=ring)
    out += rules.check_vmem_budget(location=location, block_h=TRACE_BLOCK[0],
                                   block_w=TRACE_BLOCK[1], radius=spec.radius, nms=nms,
                                   channels=3 if rgb else None, depth=depth, in_bytes=1)
    _count(report, "VMEM001")
    if depth:
        out += rules.check_dma_pipeline(_ring(depth, *TRACE_BLOCK, spec.radius, nms),
                                        location=location)
        _count(report, "PIPE001")
    if backend == "torch":
        # The plain lane's own u8 -> int cast; inside a CUDA kernel the cast
        # is no aten op, so the card reads the instances instead.
        out += rules.check_kernel_accum_dtype(trace, location=location, spec=spec)
        _count(report, "DTYPE001")
    return out


def _plan_violations(plan_name: str, backend: str, padding: str, report: Report,
                     dev) -> List[Violation]:
    """Multi-stage StencilPlan battery: the whole plan (pre-stages →
    gradient → optional NMS) runs as ONE launch (FUSE002), with the
    *composed* halo (``plan.linear_reach`` + NMS ring) as its reach, the
    shared-memory budget and the sharded exchange width."""
    from repro_torch import api
    from repro_torch.core.filters import get_plan

    plan = get_plan(plan_name)
    location = f"plan:{plan_name}/{backend}/{padding}/gray"
    cfg = api.EdgeConfig(plan=plan_name, backend=backend, padding=padding,
                         block_h=TRACE_BLOCK[0], block_w=TRACE_BLOCK[1])
    x = torch.zeros(TRACE_SHAPE, dtype=torch.uint8, device=dev)
    trace, launched = _run_traced(api.edge_detect, x, cfg, device=dev, opaque=_opaque(False))
    report.combos.append(location)
    spec = plan.gradient
    out: List[Violation] = []
    out += rules.check_fusion_purity(trace, location=location)
    _count(report, "FUSE001")
    out += _cardinality(report, location, backend, trace, launched, "k1")
    out += _probe(report, location, cfg, TRACE_SHAPE, dev, stream=False, spec=spec,
                  nms=plan.nms, plan=plan)
    out += rules.check_vmem_budget(location=location, block_h=TRACE_BLOCK[0],
                                   block_w=TRACE_BLOCK[1], radius=spec.radius,
                                   nms=plan.nms, plan=plan)
    _count(report, "VMEM001")
    if backend == "torch":
        out += rules.check_kernel_accum_dtype(trace, location=location, spec=spec, plan=plan)
        _count(report, "DTYPE001")
    return out


def _shard_violations(op: str, backend: str, report: Report, dev) -> List[Violation]:
    """FUSE002 on a sharded call: one launch (or plain-lane call) a shard,
    on a 1x2x2 mesh of the one device."""
    from repro_torch import api
    from repro_torch.sharding import halo

    location = f"shard:{op}/{backend}/1x2x2"
    mesh = halo.mesh_from_config(api.ShardConfig(1, 2, 2), [dev] * 4)
    cfg = api.EdgeConfig(operator=op, backend=backend, block_h=TRACE_BLOCK[0],
                         block_w=TRACE_BLOCK[1])
    x = torch.zeros(TRACE_SHAPE, dtype=torch.uint8, device=dev)
    trace, launched = _run_traced(api.edge_detect, x, cfg, mesh=mesh, device=dev,
                                  opaque=_opaque(False))
    report.combos.append(location)
    return _cardinality(report, location, backend, trace, launched, "k1", expected=mesh.size)


def _spec_violations(op: str, report: Report) -> List[Violation]:
    from repro_torch.core.filters import get_operator
    from repro_torch.kernels import edge, tuning

    spec = get_operator(op)
    out: List[Violation] = []
    location = f"spec:{op}"
    out += rules.check_dtype_ladder(spec, location=location)
    _count(report, "DTYPE001")
    # The fallback tile chooser, and every tile the tuner may pick, must
    # respect the budget at every service resolution, NMS's halo included;
    # K2's ring must be well formed at every depth that fits.
    for h, w in SERVICE_SHAPES:
        bh, bw = edge.default_block_shape(h, w, spec.size)
        out += rules.check_vmem_budget(location=f"{location}/default-block-{h}x{w}",
                                       block_h=bh, block_w=bw, radius=spec.radius, nms=True)
        _count(report, "VMEM001")
        for depth in (0,) + tuple(edge.PIPELINE_DEPTHS):
            for dtype, in_bytes in (("uint8", 1), ("float32", 4)):
                tiles = tuning.legal_block_shapes(h, w, operator=op, backend="cuda",
                                                  dtype=dtype, depth=depth)
                for tbh, tbw in tiles:
                    for d in ((0, depth) if depth else (0,)):
                        out += rules.check_vmem_budget(
                            location=f"{location}/legal-{h}x{w}-{tbh}x{tbw}-d{d}-{dtype}",
                            block_h=tbh, block_w=tbw, radius=spec.radius, nms=True, depth=d,
                            in_bytes=in_bytes)
                _count(report, "VMEM001", len(tiles) * (2 if depth else 1))
                if depth and tuning.tile_fits(bh, bw, spec, depth=depth, dtype=dtype):
                    out += rules.check_dma_pipeline(
                        _ring(depth, bh, bw, spec.radius, True, in_bytes),
                        location=f"{location}/ring-{h}x{w}-d{depth}-{dtype}")
                    _count(report, "PIPE001")
    report.combos.append(location)
    return out


def _static_violations(report: Report) -> List[Violation]:
    """Runtime half of DET003 on the classes the port keys caches on."""
    from repro_torch.api import EdgeConfig
    from repro_torch.core.filters import OperatorSpec, Stage, StencilPlan

    out: List[Violation] = []
    for cls, location in (
        (OperatorSpec, "class:repro_torch.core.filters.OperatorSpec"),
        (EdgeConfig, "class:repro_torch.api.EdgeConfig"),
        (StencilPlan, "class:repro_torch.core.filters.StencilPlan"),
        (Stage, "class:repro_torch.core.filters.Stage"),
    ):
        out += rules.check_static_registration(cls, location=location)
        _count(report, "DET003")
    return out


def _source_violations(report: Report) -> List[Violation]:
    from repro_torch.kernels import build

    out: List[Violation] = []
    kernel_math = set()
    for ap, rel in kernel_math_files():
        kernel_math.add(rel)
        out += ast_rules.scan_file(ap, rel=rel)
        for rule in ("DET001", "DET002", "DET003"):
            _count(report, rule)
    # Repo-wide DET003: register_static must target frozen dataclasses
    # everywhere, not just in kernel math.
    for ap, rel in _all_port_files():
        if rel not in kernel_math:
            out += ast_rules.scan_file(ap, rel=rel, rules=("DET003",))
            _count(report, "DET003")
    # FMA001's CPU half: the flags every kernel is built with, and the
    # edge kernels' sources.
    out += rules.check_contraction_fences(location="build:nvcc-flags",
                                          flags=build.NVCC_FLAGS)
    _count(report, "FMA001")
    sources = _edge_sources()
    out += rules.check_contraction_fences(location="csrc", sources=sources)
    _count(report, "FMA001", len(sources))
    return out


def _code_violations(report: Report) -> List[Violation]:
    """The compiled K1-K3 (card): FMA001 on every instance's PTX, PIPE001
    on every K2 instance's SASS, DTYPE001 on every integer-lane instance's
    accumulator. Per-instance counts go to ``meta["instances"]``."""
    from repro_torch.analysis import device
    from repro_torch.core import ladder
    from repro_torch.core.filters import get_operator, list_operators
    from repro_torch.kernels import edge

    out: List[Violation] = []
    instances = report.meta.setdefault("instances", {})
    seconds = report.meta.setdefault("seconds", {})
    accums: Dict[int, set] = {}
    for lib, prog in device.compiled_programs().items():
        for part, s in prog.seconds.items():
            seconds[f"{part}:{lib}"] = round(s, 3)
        report.meta.setdefault("functions", {})[lib] = prog.functions
        # The device functions the instances call (not inlined) are part of
        # their program too.
        out += rules.check_contraction_fences(location=f"code:{lib}", ptx=prog.helpers)
        _count(report, "FMA001", len(prog.helpers))
        for inst in device.launchable_instances():
            if inst.kernel != device.LIBRARIES[lib]:
                continue
            ops = prog.sass[inst.key]
            location = f"code:{inst.key}"
            report.combos.append(location)
            fma = len(rules._PTX_FMA.findall(prog.ptx[inst.key]))
            instances[inst.key] = {
                "sass_functions": prog.per_instance[inst.key],
                "fma.rn.f32": fma,
                "FFMA": sum(n for op, n in ops.items() if op.startswith("FFMA")),
                "static_smem": prog.static_smem[inst.key],
            }
            out += rules.check_contraction_fences(location="code",
                                                  ptx={inst.key: prog.ptx[inst.key]})
            _count(report, "FMA001")
            if inst.kernel == "pipelined_kernel":
                copies, waits = device.sass_ring_sites(ops)
                instances[inst.key].update(copies=copies, waits=waits)
                # The SASS shows the copies and waits; the slots and
                # barriers come from the layout model, at the least depth.
                lay = edge.pipelined_layout(*EXPORT_BLOCK, 2, 2, 1, 1, False)
                out += rules.check_dma_pipeline(
                    rules.RingProgram(lay["slots"], lay["barriers"], copies, waits),
                    location=location)
                _count(report, "PIPE001")
            if inst.input == "unsigned char" and inst.accum not in (None, "float"):
                accums.setdefault(inst.size, set()).add(
                    {"int": "int32", "short": "int16"}.get(inst.accum, inst.accum))
    widening = {}
    for name in list_operators():
        spec = get_operator(name)
        licensed = ladder.accum_dtype(spec)
        if licensed is None:
            continue
        found = sorted(accums.get(spec.size, ()))
        if not found:
            raise AnalysisError(f"no integer-lane instance serves operator {name!r} "
                                f"(size {spec.size})")
        out += rules.check_kernel_accum_dtype(found, location=f"code:int-lane/{name}",
                                              spec=spec)
        _count(report, "DTYPE001")
        widening[name] = {"licensed": licensed, "kernel": ",".join(found)}
    report.meta["int_lane_accumulators"] = widening
    return out


def _program_violations(report: Report, location: str, call, kernel: str, expected_smem: int,
                        pending: list, fuse003: bool = True) -> List[Violation]:
    """FUSE003 (unless ``fuse003`` is False) on one call's device program
    (the call runs once to warm up first); the launch's shared memory goes
    to ``pending`` for VMEM001, judged once the compiled code is read."""
    from repro_torch.analysis import device
    from repro_torch.kernels import build

    call()
    torch.cuda.synchronize()
    acts = device.profile_call(call, build.BUILD_DIR / "analysis")
    report.combos.append(location)
    out: List[Violation] = []
    if fuse003:
        out += rules.check_device_program([a["name"] for a in acts], location=location,
                                          kernel=_KERNELS[kernel])
        _count(report, "FUSE003")
    ours = [a for a in acts if a["cat"] == "kernel" and f"{_KERNELS[kernel]}<" in a["name"]]
    if ours:
        pending.append((location, device.instance_key(ours[0]["name"]), ours[0]["smem"],
                        expected_smem))
    return out


def _launch_smem_violations(report: Report, pending: list, dev) -> List[Violation]:
    """VMEM001's launch half: the dynamic shared memory each profiled launch
    asked for (the profiler's figure less the instance's static shared
    memory, from the compiled code) against the allocation model."""
    optin = getattr(torch.cuda.get_device_properties(dev), "shared_memory_per_block_optin", None)
    if optin is None:
        raise AnalysisError("torch reports no shared_memory_per_block_optin for the card")
    out: List[Violation] = []
    for location, key, smem, expected in pending:
        static = report.meta.get("instances", {}).get(key, {}).get("static_smem")
        if smem is None or static is None:
            raise AnalysisError(f"{location}: no shared-memory record for {key}")
        out += rules.check_launch_smem(location=location, dynamic=smem - static,
                                       expected=expected, optin=int(optin))
        _count(report, "VMEM001")
        report.meta.setdefault("launch_smem", {})[location] = {
            "instance": key, "dynamic": smem - static, "static": static}
    return out


def _export_violations(op: str, layout: str, mode: Mode, report: Report, dev,
                       pending: list) -> List[Violation]:
    """The device program of one facade call at the export geometry."""
    from repro_torch import api
    from repro_torch.core.filters import get_operator
    from repro_torch.kernels import edge

    location = f"{op}/cuda-program/{layout}/{mode.name}"
    n, h, w = EXPORT_SHAPE
    rgb = layout == "rgb"
    x = torch.zeros((n, h, w, 3) if rgb else (n, h, w), dtype=torch.uint8, device=dev)
    cfg = api.EdgeConfig(operator=op, backend="cuda", block_h=EXPORT_BLOCK[0],
                         block_w=EXPORT_BLOCK[1], **mode.kw())
    spec = get_operator(op)
    nms = bool(mode.kw().get("nms"))
    depth = int(mode.kw().get("pipeline_depth", 0))
    if depth:
        smem = edge.pipelined_smem_bytes(*EXPORT_BLOCK, spec.radius, depth, 1,
                                         3 if rgb else 1, nms)
    else:
        smem = edge.launch_smem_bytes(*EXPORT_BLOCK, spec.radius, nms)
    return _program_violations(report, location, lambda: api.edge_detect(x, cfg, device=dev),
                               "k2" if depth else "k1", smem, pending)


def _full_config_violations(report: Report, dev, pending: list) -> List[Violation]:
    """The sobel-hd FULL config (4x2048x2048 frames, its tile) through
    FUSE002, FUSE003 and VMEM001: K1 on f32 frames as the image server
    sends them, K1's NMS lane, K2 at depth 2, and K3 on a cold stream
    (FUSE002 and VMEM001)."""
    from repro_torch import api
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import edge

    full = get_config("sobel-hd")
    bh, bw = full.sobel_block_h, full.sobel_block_w
    h, w = full.image_h, full.image_w
    base = api.EdgeConfig(operator=full.sobel_operator, directions=full.sobel_directions,
                          variant=full.sobel_variant, block_h=bh, block_w=bw)
    spec = base.spec
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((4, h, w), generator=g, device=dev) * 255.0
    out: List[Violation] = []
    calls = [
        ("k1", "f32", base, edge.launch_smem_bytes(bh, bw, spec.radius)),
        ("k1", "f32-nms", base.replace(nms=True), edge.launch_smem_bytes(bh, bw, spec.radius,
                                                                          True)),
        ("k2", "f32-depth2", base.replace(pipeline_depth=2),
         edge.pipelined_smem_bytes(bh, bw, spec.radius, 2, 4, 1, False)),
    ]
    for kernel, label, cfg, smem in calls:
        location = f"full:sobel-hd/{label}"
        before = _launches()
        api.edge_detect(x, cfg, device=dev)
        after = _launches()
        launched = {k: after[k] - before[k] for k in after}
        out += rules.check_kernel_cardinality(launched[kernel], location=location,
                                              unit=f"{_KERNELS[kernel]} launch")
        _count(report, "FUSE002")
        out += rules.check_vmem_budget(location=location, block_h=bh, block_w=bw,
                                       radius=spec.radius, nms=cfg.nms,
                                       depth=cfg.pipeline_depth or 0, in_bytes=4)
        _count(report, "VMEM001")
        out += _program_violations(report, location,
                                   lambda cfg=cfg: api.edge_detect(x, cfg, device=dev), kernel,
                                   smem, pending)
    location = "full:sobel-hd/stream"

    def stream_step():
        state = api.StreamState.init(4, h, w, base, dtype=torch.float32, device=dev)
        return api.edge_detect_stream(x, base, state, device=dev)

    before = _launches()["k3"]
    stream_step()
    out += rules.check_kernel_cardinality(_launches()["k3"] - before, location=location,
                                          unit="stream_kernel launch")
    _count(report, "FUSE002")
    # K3's launch only: a stream step also casts its tile mask to int32 (a
    # copy kernel of gh x gw flags), which is no staging of the frame; the
    # reference's device-program battery leaves the stream path out too.
    out += _program_violations(report, location, stream_step, "k3",
                               edge.launch_smem_bytes(bh, bw, spec.radius), pending,
                               fuse003=False)
    return out


def _device_programs(operators: Sequence[str], mode_names: Sequence[str],
                     layouts: Sequence[str], full: bool) -> dict:
    """The device-program battery on the card, in this process: the export
    battery and the FULL config (FUSE003, the FULL config's FUSE002 and
    VMEM001). Returns its violations, artifacts, checks per rule, the
    launches whose shared memory VMEM001 judges once the compiled code is
    read, and how many profiler records were taken again."""
    from repro_torch.analysis import device

    report = Report(meta={"rule_checks": {}})
    dev = torch.device("cuda")
    pending: list = []
    for op in operators if full else operators[:1]:
        for mode_name in mode_names:
            mode = MODES[mode_name]
            if mode.export:
                report.add(_export_violations(op, "gray", mode, report, dev, pending))
    for mode_name in mode_names:
        mode = MODES[mode_name]
        if mode.export and not mode.gray_only and "rgb" in layouts:
            report.add(_export_violations(operators[0], "rgb", mode, report, dev, pending))
    report.add(_full_config_violations(report, dev, pending))
    return {"violations": [v.to_dict() for v in report.violations], "combos": report.combos,
            "rule_checks": report.meta["rule_checks"], "pending": pending,
            "dropped": device.profile_call.dropped}


def _device_programs_in_child(operators, mode_names, layouts, full) -> dict:
    """:func:`_device_programs` in a fresh Python process. On an H100 the
    profiler's records of a short window came back empty once its process
    had profiled and then gone ~30 s without (``tools/profiler_idle.py``),
    while the first windows of a process keep theirs; a caller such as
    ``chip_smoke.py`` has profiled minutes before. The operators' specs go
    along, so that one the caller registered is known there too."""
    from repro_torch.core.filters import get_operator

    src = str(_pkg().parent)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    args = json.dumps(dict(operators=list(operators), mode_names=list(mode_names),
                           layouts=list(layouts), full=full))
    specs = base64.b64encode(pickle.dumps({op: get_operator(op) for op in operators})).decode()
    code = ("import base64, json, pickle, sys\n"
            "from repro_torch.core.filters import list_operators, register_operator\n"
            "from repro_torch.analysis.sweep import _device_programs\n"
            "for name, spec in pickle.loads(base64.b64decode(sys.argv[2])).items():\n"
            "    if name not in list_operators():\n"
            "        register_operator(name, spec)\n"
            "print(json.dumps(_device_programs(**json.loads(sys.argv[1]))))\n")
    proc = subprocess.run([sys.executable, "-c", code, args, specs], capture_output=True,
                          text=True, timeout=1800, env=env)
    if proc.returncode != 0:
        lines = proc.stderr.strip().splitlines()
        raise AnalysisError(f"the device-program battery failed: "
                            f"{lines[-1] if lines else proc.returncode}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def analyze(
    *,
    operators: Optional[Sequence[str]] = None,
    backends: Optional[Sequence[str]] = None,
    paddings: Optional[Sequence[str]] = None,
    modes: Optional[Sequence[str]] = None,
    layouts: Optional[Sequence[str]] = None,
    plans: Optional[Sequence[str]] = None,
    export: bool = True,
    full: bool = False,
) -> Report:
    """Run the analyzer sweep; returns a :class:`Report` (no baseline
    applied — the CLI handles that).

    ``backends`` defaults to ``("torch",)``, the CPU half; ``"cuda"`` needs
    a CUDA device (and ``nvcc``, ``cuobjdump``, ``cu++filt``) and raises
    :class:`AnalysisError` without one. ``export=False`` skips the device
    programs and the compiled code (FUSE003 and the PTX/SASS halves)."""
    from repro_torch.core.filters import list_operators, list_plans

    if operators is None:
        operators = tuple(list_operators()) if full else DEFAULT_OPERATORS
    if plans is None:
        plans = tuple(list_plans()) if full else DEFAULT_PLANS
    backends = tuple(backends or ("torch",))
    for b in backends:
        if b not in BACKENDS:
            raise AnalysisError(f"unknown backend {b!r}; expected one of {BACKENDS}")
    if "cuda" in backends and not torch.cuda.is_available():
        raise AnalysisError("backend 'cuda' checks the kernels on the card and no CUDA "
                            "device is available; run --backends torch on the CPU")
    paddings = tuple(paddings or (PAD_MODES if full else ("reflect",)))
    mode_names = tuple(modes or MODES)
    for m in mode_names:
        if m not in MODES:
            raise AnalysisError(f"unknown mode {m!r}; expected one of {tuple(MODES)}")
    layouts = tuple(layouts or ("gray", "rgb"))
    devices = {"torch": torch.device("cpu"), "cuda": torch.device("cuda")}

    report = Report(meta={"full": full, "operators": list(operators), "plans": list(plans),
                          "backends": list(backends), "rule_checks": {}, "seconds": {}})
    not_run: Dict[str, str] = {}
    if "cuda" not in backends:
        not_run.update({r: f"card half: {why}" for r, why in _CARD_HALVES.items()})
        not_run["FUSE003"] = "needs the card (--backends cuda)"
    elif not export:
        not_run.update({r: f"card half: skipped by --no-export" for r in _EXPORT_HALVES})
        not_run["FUSE003"] = "skipped by --no-export"
    report.meta["not_run"] = not_run
    seconds = report.meta["seconds"]

    for backend in backends:
        t0 = time.perf_counter()
        dev = devices[backend]
        for op in operators:
            for layout in layouts:
                # RGB exercises the luma path, which is operator-independent
                # — one operator covers it.
                if layout == "rgb" and op != operators[0]:
                    continue
                for mode_name in mode_names:
                    mode = MODES[mode_name]
                    if mode.gray_only and layout == "rgb":
                        continue  # explicit int on RGB raises by contract
                    pads = paddings if (mode.all_paddings or not full) else ("reflect",)
                    if not mode.all_paddings:
                        pads = pads[:1]
                    for padding in pads:
                        report.add(_combo_violations(op, backend, padding, layout, mode,
                                                     report, dev))
        for plan_name in plans:
            for padding in paddings:
                report.add(_plan_violations(plan_name, backend, padding, report, dev))
        report.add(_shard_violations(operators[0], backend, report, dev))
        seconds[f"sweep:{backend}"] = round(time.perf_counter() - t0, 3)
    if "cuda" in backends and export:
        t0 = time.perf_counter()
        progs = _device_programs_in_child(operators, mode_names, layouts, full)
        report.add(Violation.from_dict(v) for v in progs["violations"])
        report.combos += progs["combos"]
        for rule, n in progs["rule_checks"].items():
            _count(report, rule, n)
        report.meta["profiles_taken_again"] = progs["dropped"]
        seconds["programs"] = round(time.perf_counter() - t0, 3)
        t0 = time.perf_counter()
        report.add(_code_violations(report))
        report.add(_launch_smem_violations(report, [tuple(p) for p in progs["pending"]],
                                           devices["cuda"]))
        seconds["code"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    for op in operators:
        report.add(_spec_violations(op, report))
    report.add(_static_violations(report))
    report.add(_source_violations(report))
    seconds["static"] = round(time.perf_counter() - t0, 3)
    return report
