"""The port's kernel contract analyzer (``repro_torch.analysis``) on the CPU.

Three parts:

* golden *known-bad* artifacts in the port's forms — a padded pipeline
  around the plain lane, unfenced multiply-adds (flags, source, PTX), an
  oversized tile, an off-by-one halo, an unfrozen cache-key class, an
  over-range integer tap bank, broken K2 rings, a narrow integer
  accumulator — each must trigger exactly its own rule id;
* report plumbing — JSON shape, human table and baselines, equal to the
  reference package's (``repro.analysis``, whose report code still runs on
  this host), and the CLI's exit codes;
* the clean tree: the committed ``analysis_baseline_torch.json`` is what
  the full CPU sweep needs, and the reference's rules that still run here
  (``scan_source``, ``check_static_registration``, the dtype ladder, the
  budget's arithmetic) agree with the port's on shared inputs.

The card half (the cuda lane, the compiled K1-K3) is in
``tests/test_torch_gpu.py``.
"""
import collections
import dataclasses
import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from repro import analysis as ref_analysis
from repro.analysis import violations as ref_violations
from repro.core import filters as ref_filters
from repro_torch import analysis
from repro_torch.analysis import device, rules
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.analysis.sweep import _edge_sources
from repro_torch.analysis.violations import Report, Violation
from repro_torch.api import EdgeConfig, edge_detect
from repro_torch.core import nms as core_nms
from repro_torch.core.filters import get_operator, list_operators, make_separable_spec
from repro_torch.kernels import build
from repro_torch.kernels import edge as ekern

ROOT = Path(__file__).resolve().parents[1]
BASELINE = ROOT / "analysis_baseline_torch.json"
SHAPE = (1, 64, 96)
OPAQUE = (ekern.edge_plain, ekern.edge_stream_plain, core_nms.hysteresis)


def _plain(spec, **kw):
    def fn(a):
        return ekern.edge_plain(a, spec=spec, variant=spec.resolve_variant("auto"),
                                directions=max(spec.directions), block_h=16, block_w=32, **kw)
    return fn


def _all_trace_rules(fn, *, spec, nms=False, block_h=16, block_w=32, channels=None,
                     allow_unstack=False, flags=build.NVCC_FLAGS, sources=None):
    """The CPU rule set as the sweep applies it to one call: FUSE001/002 on
    its trace, FMA001 on the flags and sources, HALO001 by the impulse
    probe, VMEM001 on the tile."""
    loc = "test"
    x = torch.zeros(SHAPE, dtype=torch.uint8)
    _out, trace = analysis.trace_ops(fn, x, opaque=OPAQUE)
    vios = analysis.check_fusion_purity(trace, location=loc, allow_unstack=allow_unstack)
    calls = sum(trace.calls.get(n, 0) for n in rules.PLAIN_LANE)
    vios += analysis.check_kernel_cardinality(calls, location=loc)
    vios += analysis.check_contraction_fences(location=loc, flags=flags,
                                              sources=_edge_sources() if sources is None
                                              else sources)
    r = spec.radius + int(nms)
    measured = analysis.impulse_reach(fn, SHAPE[1:], border=(32, 64), offsets=r + 2)
    vios += analysis.check_halo_window(location=loc, spec=spec, nms=nms, measured=measured)
    vios += analysis.check_vmem_budget(location=loc, block_h=block_h, block_w=block_w,
                                       radius=spec.radius, nms=nms, channels=channels)
    return vios, trace


def _rule_ids(vios):
    return {v.rule for v in vios}


def _ring(depth=2, **kw):
    lay = ekern.pipelined_layout(16, 32, 2, depth, 1, 1, False)
    copies, waits = device.k2_source_sites(
        (ROOT / "src/repro_torch/kernels/csrc/edge_pipelined.cu").read_text())
    fields = dict(depth=lay["slots"], barriers=lay["barriers"], copies=copies, waits=waits)
    fields.update(kw)
    return rules.RingProgram(**fields)


# ---------------------------------------------------------------------------
# Clean reference: the real engine passes the full rule set
# ---------------------------------------------------------------------------

def test_clean_plain_lane_passes_all_rules():
    vios, _ = _all_trace_rules(_plain(get_operator("sobel5")), spec=get_operator("sobel5"))
    assert vios == []


def test_clean_pipelined_int_lane_passes_all_rules():
    """The integer lane at a ring depth satisfies the full rule set,
    PIPE001 on K2's ring and the kernel half of DTYPE001 included."""
    spec = get_operator("sobel5")
    vios, trace = _all_trace_rules(_plain(spec, precision="int", pipeline_depth=2), spec=spec)
    vios += analysis.check_dma_pipeline(_ring(), location="test")
    vios += analysis.check_kernel_accum_dtype(trace, location="test", spec=spec)
    assert vios == []
    assert rules._traced_accumulators(trace) == ["int32"]


# ---------------------------------------------------------------------------
# Golden known-bad battery: each artifact trips exactly its rule
# ---------------------------------------------------------------------------

def test_bad_padded_pipeline_trips_fuse001_only():
    """A host-side pad around the lane and a compensating slice: the
    round trip the fused kernel exists to avoid. Only FUSE001 may fire —
    the lane itself (halo, fences, budget) is still sound."""
    spec = get_operator("sobel5")
    inner = _plain(spec)

    def bad(x):
        return inner(F.pad(x, (2, 2, 2, 2)))[:, 2:-2, 2:-2]

    vios, _ = _all_trace_rules(bad, spec=spec)
    assert _rule_ids(vios) == {"FUSE001"}
    assert {dict(v.detail)["primitive"] for v in vios} == {"constant_pad_nd", "slice"}


def test_bad_unfenced_flags_trip_fma001_only():
    """A build that lets nvcc contract (no --fmad=false, fast math): the
    hazard the fence idiom and the flags exist to prevent."""
    spec = get_operator("sobel5")
    flags = [f for f in build.NVCC_FLAGS if f != "--fmad=false"] + ["--use_fast_math"]
    vios, _ = _all_trace_rules(_plain(spec), spec=spec, flags=flags)
    assert _rule_ids(vios) == {"FMA001"}
    assert {dict(v.detail)["flag"] for v in vios} == {"--fmad=false", "--use_fast_math"}


def test_bad_unfenced_kernel_source_trips_fma001():
    """An explicit fused multiply-add in a kernel source, or in its PTX, is
    flagged; the separately rounded product and sum are clean."""
    bad = "__device__ float f(float a, float b) {\n  return fmaf(a, 2.0f, b);\n}\n"
    vios = analysis.check_contraction_fences(location="t", sources={"k.cu": bad})
    assert _rule_ids(vios) == {"FMA001"} and vios[0].location == "k.cu:2"
    good = "__device__ float f(float a, float b) {\n  return a * 2.0f + b;  // fmaf(no)\n}\n"
    assert analysis.check_contraction_fences(location="t", sources={"k.cu": good}) == []
    ptx = {"_Z1fv": ".visible .entry _Z1fv(\n)\n{\n\tfma.rn.f32 \t%f3, %f1, %f2, %f1;\n}\n"}
    vios = analysis.check_contraction_fences(location="code", ptx=ptx)
    assert _rule_ids(vios) == {"FMA001"} and "1 fma.rn.f32" in vios[0].message
    fenced = {"_Z1fv": "\tmul.rn.f32 \t%f3, %f1, %f2;\n\tadd.rn.f32 \t%f4, %f3, %f1;\n"}
    assert analysis.check_contraction_fences(location="code", ptx=fenced) == []


def test_canned_ptx_listing_is_read_per_function():
    """The PTX parser splits a listing into its functions; the contraction
    check reads each (the card half runs it on every K1-K3 instance)."""
    text = (".version 8.5\n.target sm_90a\n"
            ".visible .entry _Z3onePKf(\n\t.param .u64 p\n)\n{\n\tmul.rn.f32 %f1, %f2, %f3;\n}\n"
            ".visible .entry _Z3twoPKf(\n)\n{\n\tfma.rn.f32 %f1, %f2, %f3, %f4;\n}\n")
    listing = device.parse_ptx(text)
    assert sorted(listing) == ["_Z3onePKf", "_Z3twoPKf"]
    vios = analysis.check_contraction_fences(location="code", ptx=listing)
    assert [v.location for v in vios] == ["code/_Z3twoPKf"]


def test_bad_oversized_block_trips_vmem001_only():
    """A (512, 4096) tile's halo window blows the 232,448 B a CTA may opt
    into; every other contract (fusion, halo, fences) stays intact."""
    spec = get_operator("sobel5")
    vios, _ = _all_trace_rules(_plain(spec), spec=spec, block_h=512, block_w=4096)
    assert _rule_ids(vios) == {"VMEM001"}
    assert dict(vios[0].detail)["budget"] == str(ekern.SMEM_MAX)


def test_bad_off_by_one_halo_trips_halo001_only():
    """A lane that reaches one pixel (sobel3's stencil) while the operator
    needs two: the off-by-one the impulse probe exists to catch."""
    vios, _ = _all_trace_rules(_plain(get_operator("sobel3")), spec=get_operator("sobel5"))
    assert _rule_ids(vios) == {"HALO001"}
    assert "window reach (1, 1)" in vios[0].message


def test_bad_unfrozen_static_pytree_trips_det003_only():
    """An unfrozen dataclass as a cache key: unhashable. Caught both at
    runtime and in source, without firing the other determinism rules."""

    @dataclasses.dataclass
    class BadConfig:
        a: int = 1

    vios = analysis.check_static_registration(BadConfig, location="t")
    assert _rule_ids(vios) == {"DET003"}
    vios = analysis.scan_source(_DET003_SNIPPET, "bad_config.py")
    assert _rule_ids(vios) == {"DET003"}
    good = _DET003_SNIPPET.replace("@dataclasses.dataclass",
                                   "@dataclasses.dataclass(frozen=True)")
    assert analysis.scan_source(good, "good_config.py") == []


def test_bad_over_range_integer_taps_trip_dtype001_only():
    """Integer taps whose u8 accumulation exceeds 2^24 cannot claim the
    exact-f32 contract the integer lane relies on."""
    spec = make_separable_spec("huge", [256, 256, 256, 256, 256], [-64, -32, 0, 32, 64])
    vios = analysis.check_dtype_ladder(spec, location="spec:huge")
    vios += analysis.check_static_registration(type(spec), location="spec:huge")
    assert _rule_ids(vios) == {"DTYPE001"}
    b = analysis.tap_accumulation_bounds(spec)
    assert b["integer_taps"] and not b["f32_exact"]
    for name in ("sobel3", "sobel5", "scharr3", "prewitt3", "sobel7"):
        bounds = analysis.tap_accumulation_bounds(get_operator(name))
        assert bounds["integer_taps"] and bounds["f32_exact"] and bounds["fits_i32"], name


def test_bad_ring_without_waits_trips_pipe001_only():
    """Copies that are never waited on: the walk races the copies. Seen in
    the ring model, in K2's source with its try-wait gone, and in a canned
    SASS listing with copies and no waits."""
    vios = analysis.check_dma_pipeline(_ring(waits=0), location="t")
    assert _rule_ids(vios) == {"PIPE001"} and "no mbarrier wait" in vios[0].message
    assert analysis.check_dma_pipeline(_ring(), location="t") == []
    src = (ROOT / "src/repro_torch/kernels/csrc/edge_pipelined.cu").read_text()
    copies, waits = device.k2_source_sites(src.replace("mbarrier.try_wait", "mbarrier.test"))
    assert copies and not waits
    sass = device.parse_sass(
        "\t\tFunction : _Z16pipelined_kernelv\n"
        "        /*0100*/                   UTMALDG.3D [UR8], [UR4] ;   /* 0x0 */\n"
        "        /*0110*/                   LDGSTS.E.BYPASS.128 [R1], desc[UR6][R2.64] ;\n"
        "        /*0120*/                   SYNCS.ARRIVE.TRANS64.RED.A1T0 RZ, [R3] ;\n")
    copies, waits = device.sass_ring_sites(sass["_Z16pipelined_kernelv"])
    assert (copies, waits) == (2, 0)
    vios = analysis.check_dma_pipeline(_ring(copies=copies, waits=waits), location="t")
    assert _rule_ids(vios) == {"PIPE001"}


def test_bad_single_slot_ring_trips_pipe001():
    """depth=1 means the walk always blocks on the copy it just issued —
    no overlap, no pipeline. The depth floor is 2."""
    vios = analysis.check_dma_pipeline(_ring(depth=1, barriers=1), location="t")
    assert _rule_ids(vios) == {"PIPE001"}
    assert any("depth 1 < 2" in v.message for v in vios)


def test_bad_barrier_ring_mismatch_trips_pipe001():
    """One mbarrier shared by two ring slots: waits cannot pair with
    copies per slot."""
    vios = analysis.check_dma_pipeline(_ring(depth=2, barriers=1), location="t")
    assert _rule_ids(vios) == {"PIPE001"}
    assert "1 mbarrier(s) for a depth-2 ring" in vios[0].message


def test_bad_narrow_accumulation_trips_dtype001_only():
    """A lane that accumulates sobel5 taps in i16 — the ladder proves the
    pairwise bound needs i32, so i16 wraps. The kernel half of DTYPE001
    catches what the spec half cannot see."""
    spec5 = get_operator("sobel5")
    x = torch.zeros(SHAPE, dtype=torch.uint8)
    _o, trace = analysis.trace_ops(lambda a: (a.to(torch.int16) * 2).to(torch.float32), x)
    vios = analysis.check_kernel_accum_dtype(trace, location="t", spec=spec5)
    assert _rule_ids(vios) == {"DTYPE001"}
    assert "accumulates u8 taps in int16" in vios[0].message
    # The licensed dtype is clean; wider than licensed stays exact and is
    # clean too (the card's integer lane runs sobel3's i16 math in i32).
    _o, trace32 = analysis.trace_ops(lambda a: (a.to(torch.int32) * 2).to(torch.float32), x)
    assert analysis.check_kernel_accum_dtype(trace32, location="t", spec=spec5) == []
    assert analysis.check_kernel_accum_dtype(trace32, location="t",
                                             spec=get_operator("sobel3")) == []
    assert analysis.check_kernel_accum_dtype(["int32"], location="t",
                                             spec=get_operator("sobel3")) == []
    # A trace with no u8 -> int cast (the f32 lane) passes vacuously.
    _o, trace_f = analysis.trace_ops(lambda a: a.to(torch.float32) * 2.0, x)
    assert analysis.check_kernel_accum_dtype(trace_f, location="t", spec=spec5) == []


def test_bad_wrong_radius_ring_trips_halo001():
    """HALO001's ring branch: a K2 ring laid out for r=1 (sobel3) cannot
    feed an r=2 stencil."""
    lay = ekern.pipelined_layout(16, 32, get_operator("sobel3").radius, 2, 1, 1, False)
    ring = (lay["eh"], lay["ew"])
    vios = analysis.check_halo_window(location="t", spec=get_operator("sobel5"), nms=False,
                                      ring_window=ring, block=(16, 32))
    assert _rule_ids(vios) == {"HALO001"} and "ring slot window" in vios[0].message
    assert analysis.check_halo_window(location="t", spec=get_operator("sobel3"), nms=False,
                                      ring_window=ring, block=(16, 32)) == []


# ---------------------------------------------------------------------------
# Determinism source rules (DET001/DET002), and the port's own findings
# ---------------------------------------------------------------------------

_DET001_SNIPPET = (
    "import time\n"
    "import numpy as np\n"
    "def f():\n"
    "    t = time.perf_counter()\n"
    "    return np.random.default_rng().normal() + t\n"
)
_DET003_SNIPPET = (
    "import dataclasses\n"
    "import jax\n"
    "\n"
    "@dataclasses.dataclass\n"
    "class BadConfig:\n"
    "    a: int = 1\n"
    "\n"
    "jax.tree_util.register_static(BadConfig)\n"
)


def test_det001_wall_clock_and_randomness():
    vios = analysis.scan_source(_DET001_SNIPPET, "m.py")
    assert _rule_ids(vios) == {"DET001"}
    assert len(vios) == 3  # the import, the clock call, the RNG call


def test_det002_python_branch_on_tensor():
    src = (
        "import torch\n"
        "import numpy as np\n"
        "def f(x, taps):\n"
        "    if np.any(taps):\n"                # static host data: fine
        "        x = x + 1\n"
        "    if torch.any(x > 0):\n"            # a device -> host read: DET002
        "        x = x * 2\n"
        "    while torch.max(x) > 1:\n"         # DET002
        "        x = x / 2\n"
        "    n = x.reshape(-1) if torch.numel(x) > 2 else x\n"  # static query: fine
        "    assert torch.is_floating_point(x)\n"               # static query: fine
        "    return n\n"
    )
    vios = analysis.scan_source(src, "m.py")
    assert _rule_ids(vios) == {"DET002"}
    assert {dict(v.detail)["call"] for v in vios} == {"torch.any", "torch.max"}


def test_det002_finds_the_hysteresis_fixpoint_test():
    """The one branch on a tensor in the port's kernel math: hysteresis's
    fixpoint test (a flag read back per burst of dilation steps), listed in
    the committed baseline with its reason."""
    path = ROOT / "src/repro_torch/core/nms.py"
    vios = analysis.scan_file(str(path), rel="src/repro_torch/core/nms.py")
    assert [(v.rule, dict(v.detail)["call"]) for v in vios] == [("DET002", "torch.equal")]
    line = path.read_text().splitlines()[int(vios[0].location.rsplit(":", 1)[1]) - 1]
    assert "torch.equal(cur, before)" in line
    assert vios[0].fingerprint in analysis.load_baseline(str(BASELINE))


@pytest.mark.parametrize("snippet", [_DET001_SNIPPET, _DET003_SNIPPET,
                                     _DET003_SNIPPET.replace("@dataclasses.dataclass",
                                                             "@dataclasses.dataclass(frozen=True)"),
                                     "import numpy as np\nx = np.zeros(3)\n"],
                         ids=("det001", "det003", "det003-frozen", "clean"))
def test_scan_source_matches_the_reference(snippet):
    got = [v.to_dict() for v in analysis.scan_source(snippet, "m.py")]
    want = [v.to_dict() for v in ref_analysis.scan_source(snippet, "m.py")]
    assert got == want


# ---------------------------------------------------------------------------
# Component-unstack allowance: scoped, not a blanket slice pass
# ---------------------------------------------------------------------------

def test_unstack_allowance_is_scoped():
    cfg = EdgeConfig(operator="sobel5", block_h=16, block_w=32, with_orientation=True)
    x = torch.zeros(SHAPE, dtype=torch.uint8)
    _o, trace = analysis.trace_ops(edge_detect, x, cfg, device="cpu", opaque=OPAQUE)
    # Without the allowance the plane peels are (correctly) flagged...
    flagged = analysis.check_fusion_purity(trace, location="t")
    assert {dict(v.detail)["primitive"] for v in flagged} == {"select", "unbind"}
    # ...with it the path is clean, but only views of the exact
    # (N, D, H, W) -> plane signature are excused.
    assert analysis.check_fusion_purity(trace, location="t", allow_unstack=True) == []
    comps = torch.zeros((1, 4, 64, 96))
    _o, crop = analysis.trace_ops(lambda c: c[:, :, 2:-2].contiguous(), comps)
    assert _rule_ids(analysis.check_fusion_purity(crop, location="t",
                                                  allow_unstack=True)) == {"FUSE001"}


def test_hysteresis_scope_is_opaque_only_under_its_mode():
    cfg = EdgeConfig(operator="sobel5", block_h=16, block_w=32, hysteresis=True)
    x = torch.zeros(SHAPE, dtype=torch.uint8)
    _o, trace = analysis.trace_ops(edge_detect, x, cfg, device="cpu", opaque=OPAQUE)
    assert trace.calls == {"edge_plain": 1, "hysteresis": 1}
    assert _rule_ids(analysis.check_fusion_purity(trace, location="t")) == {"FUSE001"}
    assert analysis.check_fusion_purity(
        trace, location="t", opaque=rules.PLAIN_LANE + ("hysteresis",)) == []


# ---------------------------------------------------------------------------
# Report format (equal to the reference's), baselines, RULES, CLI
# ---------------------------------------------------------------------------

_TOY = [("FUSE001", "c/d", "1 HBM-level `pad` op(s) in a fused path",
         (("count", "1"), ("primitive", "pad"))),
        ("FMA001", "a/b", "unfenced float mul feeding add", ())]


def _toy_report(mod=None):
    R, V = (Report, Violation) if mod is None else (mod.Report, mod.Violation)
    r = R(checks=7, combos=["a/b", "c/d"])
    r.add([V(rule, loc, msg, detail=d) for rule, loc, msg, d in _TOY])
    return r


def test_report_json_snapshot():
    got = _toy_report().to_json_dict()
    assert got == {
        "version": 1,
        "ok": False,
        "checks": 7,
        "combos": ["a/b", "c/d"],
        "summary": {"FMA001": 1, "FUSE001": 1},
        "violations": [
            {"rule": "FMA001", "location": "a/b",
             "message": "unfenced float mul feeding add", "detail": {}},
            {"rule": "FUSE001", "location": "c/d",
             "message": "1 HBM-level `pad` op(s) in a fused path",
             "detail": {"count": "1", "primitive": "pad"}},
        ],
        "allowlisted": [],
        "meta": {},
    }
    v = Violation.from_dict(json.loads(json.dumps(got["violations"][1])))
    assert v.rule == "FUSE001" and v.fingerprint == "FUSE001|c/d"


def test_report_render_table():
    lines = _toy_report().render().splitlines()
    assert lines[0] == "repro.analysis: 7 checks over 2 artifacts"
    assert "RULE" in lines[1] and "LOCATION" in lines[1]
    assert any(line.lstrip().startswith("FMA001") for line in lines)
    assert lines[-1].startswith("FAIL: 2 new violation(s)")
    assert Report(checks=3, combos=["x"]).render().splitlines()[-1] == "OK: no new violations"


@pytest.mark.parametrize("verbose", (False, True))
def test_report_equals_the_references(verbose):
    """The same violations give the same JSON and the same table in both
    packages, allowlisted ones included."""
    ours, theirs = _toy_report(), _toy_report(ref_violations)
    allow = {"FMA001|a/b": "known"}
    ours.apply_baseline(allow)
    theirs.apply_baseline(allow)
    assert ours.to_json_dict() == theirs.to_json_dict()
    assert ours.render(verbose=verbose) == theirs.render(verbose=verbose)


@pytest.mark.parametrize("writer,reader", [("port", "reference"), ("reference", "port"),
                                           ("port", "port")])
def test_baseline_round_trip(tmp_path, writer, reader):
    mods = {"port": analysis, "reference": ref_analysis}
    path = str(tmp_path / "baseline.json")
    mods[writer].write_baseline(path, _toy_report(None if writer == "port" else ref_violations))
    allow = mods[reader].load_baseline(path)
    assert set(allow) == {"FUSE001|c/d", "FMA001|a/b"}
    again = _toy_report()
    again.apply_baseline(allow)
    assert again.ok and len(again.allowlisted) == 2
    fresh = _toy_report()
    fresh.add([Violation("FUSE001", "new/place", "pad")])
    fresh.apply_baseline(allow)
    assert not fresh.ok and [v.location for v in fresh.violations] == ["new/place"]


def test_rules_table_matches_the_reference():
    assert list(analysis.RULES) == list(ref_analysis.RULES)
    for rule_id, rule in analysis.RULES.items():
        assert rule.id == rule_id
        assert rule.name == ref_analysis.RULES[rule_id].name
        assert rule.name and rule.guards and rule.since


def test_coverage_names_every_rule_and_what_did_not_run():
    report = analysis.analyze(operators=["sobel3"], modes=["plain"], layouts=["gray"],
                              plans=[])
    text = analysis.render_coverage(report)
    assert text.splitlines()[0] == "backends: torch"
    for rule_id in analysis.RULES:
        assert f"  {rule_id} (" in text
    assert "FUSE003 (mosaic-purity): not run: needs the card" in text
    assert report.meta["rule_checks"]["HALO001"] >= 1
    assert "card half" in report.meta["not_run"]["FMA001"]


_FAST = ["--operators", "sobel3", "--modes", "plain", "--layouts", "gray", "--plans", ""]


def test_cli_fast_path_exits_zero(tmp_path, capsys):
    """The committed baseline is the default allowlist."""
    out = str(tmp_path / "report.json")
    rc = analysis_main(_FAST + ["--json", out])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "OK: no new violations" in printed and "FUSE003 (mosaic-purity): not run" in printed
    data = json.loads(open(out).read())
    assert data["ok"] is True
    assert "sobel3/torch/reflect/gray/plain" in data["combos"]


def test_cli_exits_one_on_new_violations(capsys):
    """Without the baseline the hysteresis fixpoint test is a new DET002."""
    assert analysis_main(_FAST + ["--baseline", ""]) == 1
    assert "DET002" in capsys.readouterr().out


@pytest.mark.parametrize("args", (["--backends", "cuda"], ["--backends", "tpu"],
                                  ["--modes", "nosuchmode"], ["--operators", "nosuchop"],
                                  ["--baseline", "no/such/baseline.json"]),
                         ids=("cuda-without-card", "unknown-backend", "unknown-mode",
                              "unknown-operator", "missing-baseline"))
def test_cli_exits_two_on_misuse(monkeypatch, capsys, args):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert analysis_main(_FAST + args) == 2
    assert "internal error" in capsys.readouterr().err


def test_cli_write_baseline(tmp_path):
    path = str(tmp_path / "b.json")
    assert analysis_main(_FAST + ["--write-baseline", path]) == 0
    assert set(analysis.load_baseline(path)) == set(analysis.load_baseline(str(BASELINE)))


# ---------------------------------------------------------------------------
# The clean tree, and the reference's rules that still run here
# ---------------------------------------------------------------------------

def test_committed_baseline_is_what_the_clean_sweep_needs():
    """``--all`` on the CPU: every violation is in the committed baseline
    with a reason, and every baseline entry still fires."""
    report = analysis.analyze(full=True)
    allow = analysis.load_baseline(str(BASELINE))
    assert {v.fingerprint for v in report.violations} == set(allow)
    assert all(reason.strip() for reason in allow.values())
    data = json.loads(BASELINE.read_text())
    assert data["clean_run"]["new_violations"] == 0
    assert collections.Counter(report.meta["rule_checks"]).keys() == set(analysis.RULES) - {
        "FUSE003"}


@pytest.mark.parametrize("frozen", (False, True))
def test_static_registration_matches_the_reference(frozen):
    @dataclasses.dataclass(frozen=frozen)
    class Cfg:
        a: int = 1

    got = [v.to_dict() for v in analysis.check_static_registration(Cfg, location="c")]
    want = [v.to_dict() for v in ref_analysis.check_static_registration(Cfg, location="c")]
    assert got == want and bool(got) != frozen


@pytest.mark.parametrize("name", list_operators())
def test_dtype_ladder_matches_the_reference(name):
    ours, theirs = get_operator(name), ref_filters.get_operator(name)
    assert analysis.tap_accumulation_bounds(ours) == ref_analysis.tap_accumulation_bounds(theirs)
    assert analysis.check_dtype_ladder(ours, location="s") == []
    assert ref_analysis.check_dtype_ladder(theirs, location="s") == []
    huge = ([256.0] * 5, [-64.0, -32.0, 0.0, 32.0, 64.0])
    got = analysis.check_dtype_ladder(make_separable_spec("huge", *huge), location="s")
    want = ref_analysis.check_dtype_ladder(ref_filters.make_separable_spec("huge", *huge),
                                           location="s")
    assert [v.to_dict() for v in got] == [v.to_dict() for v in want]


@pytest.mark.parametrize("plan", (None, "canny5", "blur_sobel5"))
@pytest.mark.parametrize("nms", (False, True))
def test_vmem_budget_arithmetic_matches_the_reference(plan, nms):
    """Where both packages are given the same budget, they derive the same
    window reach (a plan's composed reach, + 1 with NMS), flag the same
    tiles and report the same detail keys; each sizes the tile by its own
    device's footprint."""
    from repro.core.filters import get_plan as ref_get_plan
    from repro_torch.core.filters import get_plan

    kw = dict(location="t", block_h=16, block_w=32, radius=2, nms=nms)
    ours = analysis.check_vmem_budget(budget=0, plan=plan and get_plan(plan), **kw)
    theirs = ref_analysis.check_vmem_budget(budget=0, plan=plan and ref_get_plan(plan), **kw)
    assert _rule_ids(ours) == _rule_ids(theirs) == {"VMEM001"}
    assert ours[0].message.split(" needs ")[0] == theirs[0].message.split(" needs ")[0]
    assert dict(ours[0].detail).keys() == dict(theirs[0].detail).keys()
    assert dict(ours[0].detail)["budget"] == dict(theirs[0].detail)["budget"] == "0"
    need = int(dict(ours[0].detail)["bytes"])
    assert analysis.check_vmem_budget(budget=need, plan=plan and get_plan(plan), **kw) == []
    assert analysis.check_vmem_budget(budget=need - 1, plan=plan and get_plan(plan), **kw)


def test_impulse_probe_measures_every_registered_reach():
    """On the plain lane, the probe measures ``window_radius`` for every
    operator with and without NMS, and a plan's composed reach."""
    from repro_torch.kernels.tiling import window_radius
    from repro_torch.sharding import halo

    for name in list_operators():
        spec = get_operator(name)
        for nms in (False, True):
            cfg = EdgeConfig(operator=name, nms=nms, normalize=False, block_h=16, block_w=32)
            r = window_radius(spec.radius, nms)
            got = analysis.impulse_reach(
                lambda b: edge_detect(b, cfg, device="cpu").magnitude, SHAPE[1:],
                border=(32, 64), offsets=r + 2)
            assert got == (r, r) == (halo.exchange_radius(spec, nms),) * 2, (name, nms)


def test_launchable_instances_mirror_the_c_dispatch():
    """84 instances: K1 and K2, 3 lanes x 6 tap sets x 2 pre-stage forms
    each; K3, 2 inputs x 6 tap sets. Every demangled form maps back."""
    insts = device.launchable_instances()
    assert len({i.key for i in insts}) == len(insts) == 84
    by = collections.Counter(i.kernel for i in insts)
    assert by == {"edge_kernel": 36, "pipelined_kernel": 36, "stream_kernel": 12}
    name = ("void pipelined_kernel<(int)5, unsigned char, int, Sobel5Default<4> , (bool)1>"
            "(unsigned char const*, Geom, int, int)")
    assert device.instance_key(name) == "pipelined_kernel<5, unsigned char, int, " \
                                        "Sobel5Default<4>, true>"
    assert device.instance_key("void at::native::vectorized_elementwise_kernel<4>()") is None


def test_device_program_rule_on_canned_activity():
    ok = ["void edge_kernel<5, float, float, Sobel5Default<4>, false>(float const*)",
          "void at::native::reduce_kernel<512, 1>(at::native::ReduceOp<float>)",
          "void at::native::vectorized_elementwise_kernel<4, at::native::MulFunctor<float>>()"]
    assert analysis.check_device_program(ok, location="t", kernel="edge_kernel") == []
    bad = ok + ["Memcpy HtoD (Pageable -> Device)",
                "void at::native::unrolled_elementwise_kernel<direct_copy_kernel_cuda>()"]
    vios = analysis.check_device_program(bad, location="t", kernel="edge_kernel")
    assert _rule_ids(vios) == {"FUSE003"}
    assert {dict(v.detail)["op"] for v in vios} == {"memcpy", "copy"}
    two = analysis.check_device_program(ok + ok[:1], location="t", kernel="edge_kernel")
    assert "2 edge_kernel launch(es)" in two[0].message
    with pytest.raises(analysis.AnalysisError):
        analysis.check_device_program([], location="t", kernel="edge_kernel")


@pytest.mark.parametrize("listing", ("", "code for sm_90a\n\t.headerflags @\"EF_CUDA_SM90\"\n"),
                         ids=("empty", "no-function"))
def test_empty_listing_raises(monkeypatch, tmp_path, listing):
    """A listing with no function for an instance the wrapper can launch
    is an error (exit 2), never a pass."""
    monkeypatch.setattr(build, "build", lambda names=None: {})
    monkeypatch.setattr(build, "library_path", lambda name: tmp_path / f"lib{name}.so")
    monkeypatch.setattr(device, "_tool", lambda name: name)
    monkeypatch.setattr(device, "_run", lambda cmd, stdin=None: listing)
    with pytest.raises(analysis.AnalysisError, match="holds no function"):
        device.compiled_program("edge")

