"""Stencil plans in the port against the reference's plan layer and XLA lane.

The registry, the gate-named validation, ``plan_identity`` and the integer
lane's plan bounds are held to ``repro.core.filters`` / ``repro.core.ladder``
value for value. ``plan_components``, ``sobel_components(plan=)``,
``thin_map(plan=)`` and ``edge_detect(plan=..., device="cpu")`` (the plain
version K1 and K2 are held to on the card) must equal the reference's
``backend="xla"`` lane bit for bit (orientation within 1 ulp, as
``torch.atan2`` and ``jnp.arctan2`` may differ there) on the built-in plans
and on custom plans carried across with ``filters.carry_plan``, at every
padding, on gray and RGB u8/f32 frames. Inputs come from seeded numpy.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.core import filters as RF
from repro.core import ladder as RL
from repro.core import nms as ref_nms
from repro_torch import api
from repro_torch.core import filters as F
from repro_torch.core import ladder as L
from repro_torch.core import nms as pnms
from repro_torch.core import sobel as psobel
from repro_torch.kernels import dispatch, tuning
from repro_torch.kernels import edge as ekern

# repro.core re-exports the function sobel under the module's name.
ref_sobel = importlib.import_module("repro.core.sobel")

PADDINGS = ("reflect", "edge", "zero")
KINDS = ("u8", "f32", "rgb", "rgb_f32")
SIZES = ((1, 1), (2, 3), (37, 53), (70, 270))


def _box3():
    """An integer-tap separable smoothing stage (sum |taps| = 9)."""
    one = np.ones(3, np.float32)
    return RF.linear_stage("box3", RF.OperatorSpec(
        name="box3", size=3, directions=(1,), variants=("direct", "separable"),
        taps=RF._tupleize(np.outer(one, one)[None]), sep=((RF._tupleize(one),
                                                           RF._tupleize(one)),)))


def _cross3():
    """A dense (non-separable) integer-tap smoothing stage."""
    k = np.array([[0, 1, 0], [1, 4, 1], [0, 1, 0]], np.float32)
    return RF.linear_stage("cross3", RF.OperatorSpec(
        name="cross3", size=3, directions=(1,), variants=("direct",),
        taps=RF._tupleize(k[None]), sep=(None,)))


# Reference plans covering every stage kind: the built-ins, two pre-stages in
# a row, window max and min, abs, square, an integer separable and a dense
# linear stage, 3x3 and 2-direction gradients, with and without NMS.
REF_PLANS = {
    "canny5": RF.get_plan("canny5"),
    "blur_sobel5": RF.get_plan("blur_sobel5"),
    "g3_dilate_sobel5_nms": RF.make_plan("g3d", ("gaussian3", "dilate3", "sobel5", "nms")),
    "erode_abs_sobel3": RF.make_plan("ea", ("erode3", RF.pointwise_stage("abs", "abs"), "sobel3")),
    "square_g3_scharr3_nms": RF.make_plan("sq", (RF.pointwise_stage("square", "square"), "gaussian3",
                                                  "scharr3", "nms")),
    "dilate_sobel5_nms": RF.make_plan("dil", ("dilate3", "sobel5", "nms")),
    "box3_erode_sobel3_nms": RF.make_plan("box", (_box3(), "erode3", "sobel3", "nms")),
    "cross3_sobel5": RF.make_plan("cross", (_cross3(), "sobel5")),
}
# Plans the integer lane takes (integer taps, bound within 2^24).
INT_PLANS = ("erode_abs_sobel3", "dilate_sobel5_nms", "box3_erode_sobel3_nms", "cross3_sobel5")


def carry(ref_plan) -> F.StencilPlan:
    """The port's plan from the reference plan's stage fields and arrays."""
    stages = []
    for s in ref_plan.stages:
        op = None
        if s.operator is not None:
            o = s.operator
            op = dict(
                name=o.name, size=o.size, directions=o.directions, variants=o.variants,
                taps=np.asarray(o.taps, np.float32),
                sep=[None if f is None else (np.asarray(f[0], np.float32),
                                             np.asarray(f[1], np.float32)) for f in o.sep],
                v2_factors=(None if o.v2_factors is None
                            else [np.asarray(v, np.float32) for v in o.v2_factors]),
            )
        stages.append(dict(name=s.name, kind=s.kind, radius=s.radius, op=s.op, operator=op))
    return F.carry_plan(ref_plan.name, stages)


def _frames(kind, shape, seed):
    rng = np.random.default_rng(seed)
    shape = tuple(shape) + ((3,) if kind.startswith("rgb") else ())
    if kind in ("u8", "rgb"):
        return rng.integers(0, 256, shape).astype(np.uint8)
    noisy = rng.uniform(0, 255, shape) + rng.normal(0, 2, shape)
    return np.clip(noisy, 0, 255).astype(np.float32)


def _eq(got: torch.Tensor, want, msg=""):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, msg
    np.testing.assert_array_equal(got, want, err_msg=msg)


# ---------------------------------------------------------------------------
# Registry and structure
# ---------------------------------------------------------------------------

def test_builtin_plan_registry():
    assert {"canny5", "blur_sobel5"} <= set(F.list_plans())
    assert F.list_plans() == RF.list_plans()
    assert F.list_stages() == RF.list_stages()
    canny = F.get_plan("canny5")
    assert [s.name for s in canny.stages] == ["gaussian5", "sobel5", "nms"]
    assert canny.nms and canny.linear_reach == 4 and canny.reach == 5
    assert canny.gradient == F.get_operator("sobel5")
    assert canny.pre_stages[0].single_plane and not canny.single_operator
    blur = F.get_plan("blur_sobel5")
    assert not blur.nms and blur.linear_reach == 4 and blur.reach == 4
    assert F.resolve_plan(None) is None
    assert F.resolve_plan("canny5") is canny and F.resolve_plan(canny) is canny
    with pytest.raises(TypeError):
        F.resolve_plan(5)


def test_plan_is_hashable_and_rebuilds_equal():
    plan = F.get_plan("canny5")
    assert hash(plan) == hash(F.make_plan("canny5", ("gaussian5", "sobel5", "nms")))
    assert plan == F.make_plan("canny5", ("gaussian5", "sobel5", "nms"))


def test_gaussian_taps_are_exact_dyadic_and_equal_the_reference():
    for name in ("gaussian3", "gaussian5"):
        port, ref = F.get_stage(name).operator, RF.get_stage(name).operator
        assert port.taps == ref.taps and port.sep == ref.sep
    row = np.asarray(F.get_stage("gaussian5").operator.sep[0][0], np.float64)
    np.testing.assert_array_equal(row * 16.0, [1.0, 4.0, 6.0, 4.0, 1.0])


@pytest.mark.parametrize("name", sorted(REF_PLANS))
def test_plan_identity_equals_the_reference(name):
    ref = REF_PLANS[name]
    port = carry(ref)
    assert F.plan_identity(port) == RF.plan_identity(ref)
    assert (port.linear_reach, port.reach, port.nms, port.single_operator) == (
        ref.linear_reach, ref.reach, ref.nms, ref.single_operator)
    assert [s.name for s in port.pre_stages] == [s.name for s in ref.pre_stages]
    assert np.array_equal(port.gradient.bank(), ref.gradient.bank())


def test_carried_builtins_equal_the_registry():
    for name in ("canny5", "blur_sobel5"):
        assert carry(REF_PLANS[name]) == F.get_plan(name)


# ---------------------------------------------------------------------------
# Gates: each rejection names its gate, in both packages
# ---------------------------------------------------------------------------

@dataclasses.dataclass  # not frozen: plans must be hashable
class _MutableStage:
    name: str = "mut"
    kind: str = "pointwise"
    radius: int = 0


GATES = {
    "unknown-stage": lambda m: m.make_plan("p", ("no-such-stage", "sobel5")),
    "frozen-stage": lambda m: m.StencilPlan(name="p", stages=(_MutableStage(),)),
    "window-radius": lambda m: m.window_stage("null-window", "max", 0),
    "window-op": lambda m: m.window_stage("w", "median", 1),
    "nms-last": lambda m: m.make_plan("p", ("nms", "sobel5")),
    "nms-gradient": lambda m: m.make_plan("p", ("gaussian5", "nms")),
    "gradient-last": lambda m: m.make_plan("p", ("sobel5", "gaussian5")),
    "empty-plan": lambda m: m.StencilPlan(name="p", stages=()),
    "unknown-plan": lambda m: m.get_plan("no-such-plan"),
    "stage-kind": lambda m: m.Stage(name="s", kind="fft"),
    "stage-radius": lambda m: m.Stage(name="n", kind="nms", radius=2),
    "unknown-pointwise": lambda m: m.pointwise_stage("p", "cube"),
}


@pytest.mark.parametrize("gate", sorted(GATES))
def test_gate_named_in_both_packages(gate):
    msgs = []
    for module in (F, RF):
        with pytest.raises(ValueError, match=f"plan gate '{gate}'") as err:
            GATES[gate](module)
        msgs.append(str(err.value))
    if gate not in ("unknown-stage", "frozen-stage"):  # these name the package's repr
        assert msgs[0] == msgs[1]


def test_gate_unknown_plan_through_the_config():
    with pytest.raises(ValueError, match="plan gate 'unknown-plan'"):
        api.EdgeConfig(plan="no-such-plan").resolved()


def test_gate_nms_requested_without_nms_stage():
    for kw in (dict(nms=True), dict(hysteresis=True)):
        with pytest.raises(ValueError, match="plan gate 'nms-stage'"):
            api.EdgeConfig(plan="blur_sobel5", **kw).resolved()
        with pytest.raises(ValueError, match="plan gate 'nms-stage'"):
            ref_api.EdgeConfig(plan="blur_sobel5", **kw).resolved()


def test_gate_integer_taps():
    """precision="int" with the Gaussian's fractional taps raises the gate,
    on the config path and at the plain kernel version."""
    img = _frames("u8", (1, 32, 48), 0)
    with pytest.raises(ValueError, match="plan gate 'integer-taps'"):
        api.edge_detect(img, api.EdgeConfig(plan="canny5", precision="int"), device="cpu")
    with pytest.raises(ValueError, match="plan gate 'integer-taps'"):
        api.edge_detect(img, api.EdgeConfig(plan="blur_sobel5", precision="int"),
                        device="cpu")
    with pytest.raises(ValueError, match="plan gate 'integer-taps'"):
        ekern.edge_plain(torch.from_numpy(img), plan="blur_sobel5", variant="v2",
                         directions=4, precision="int")


def test_kernel_refuses_what_it_cannot_run():
    """The CUDA wrappers' packing raises, naming the gate, for plans the
    kernels do not take; the plain version runs them."""
    wide = RF.make_plan("wide", (RF.window_stage("dil11", "max", 5), "sobel5"))
    many = RF.make_plan("many", (RF.pointwise_stage("abs", "abs"),) * 5 + ("sobel3",))
    for ref in (wide, many):
        plan = carry(ref)
        with pytest.raises(ValueError, match="plan gate 'kernel-stage'"):
            ekern._pack_pre(plan, plan.gradient)
        ekern.edge_plain(torch.zeros((1, 12, 14)), plan=plan, variant=plan.gradient.variants[-1],
                         directions=max(plan.gradient.directions))
    F.register_pointwise("neg_test", torch.neg)
    try:
        plan = F.make_plan("neg", (F.pointwise_stage("n", "neg_test"), "sobel5"))
        with pytest.raises(ValueError, match="plan gate 'kernel-stage'"):
            ekern._pack_pre(plan, plan.gradient)
    finally:
        del F._POINTWISE_FNS["neg_test"]


def test_plan_kernel_checks():
    x = torch.zeros((1, 8, 8))
    with pytest.raises(ValueError, match="out_nms"):
        ekern.edge_plain(x, plan="canny5", variant="v2", directions=4)
    with pytest.raises(ValueError, match="no gradient stage"):
        ekern.edge_plain(x, plan=F.make_plan("b", ("gaussian5",)), variant="v2", directions=4)
    with pytest.raises(ValueError, match="not the gradient stage"):
        ekern.edge_plain(x, plan="blur_sobel5", spec=F.get_operator("sobel3"),
                         variant="separable", directions=4)
    with pytest.raises(ValueError, match="no gradient stage"):
        api.EdgeConfig(plan=F.make_plan("b", ("gaussian5",))).resolved()


def test_streaming_rejects_plans_with_pre_stages_in_the_reference_words():
    frames = _frames("u8", (1, 32, 48), 1)
    with pytest.raises(ValueError, match="stream path") as port:
        api.edge_detect_stream(frames, api.EdgeConfig(plan="canny5", block_h=8, block_w=16),
                               device="cpu")
    cfg = ref_api.EdgeConfig(plan="canny5", block_h=8, block_w=16)
    with pytest.raises(ValueError, match="stream path") as ref:
        ref_api.edge_detect_stream(jnp.asarray(frames), cfg,
                                   ref_api.StreamState.init(1, 32, 48, cfg))
    assert str(port.value) == str(ref.value)


def test_single_operator_plan_streams_as_its_operator():
    frames = _frames("u8", (2, 40, 56), 2)
    solo = F.make_plan("solo5", ("sobel5", "nms"))
    base = api.EdgeConfig(block_h=16, block_w=32, hysteresis=True, with_max=True)
    a, _ = api.edge_detect_stream(frames, base.replace(plan=solo), device="cpu")
    b, _ = api.edge_detect_stream(frames, base, device="cpu")
    for f in ("magnitude", "peak", "edges"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# ---------------------------------------------------------------------------
# Facade threading
# ---------------------------------------------------------------------------

def test_resolved_pins_operator_and_nms():
    cfg = api.EdgeConfig(plan="canny5", operator="sobel3").resolved()
    assert cfg.operator == "sobel5" and cfg.nms is True
    assert cfg.spec == F.get_plan("canny5").gradient and cfg.plan is F.get_plan("canny5")
    assert cfg.resolved() == cfg
    cfg2 = api.EdgeConfig(plan="blur_sobel5").resolved()
    assert cfg2.operator == "sobel5" and cfg2.nms is False
    ref = ref_api.EdgeConfig(plan="canny5", operator="sobel3").resolved()
    assert (ref.operator, ref.nms, ref.directions, ref.variant) == (
        cfg.operator, cfg.nms, cfg.directions, cfg.variant)


def test_single_operator_plan_collapses_to_operator_path():
    plan = F.make_plan("solo5", ("sobel5",))
    assert plan.single_operator and ekern.kernel_plan(plan, False) is None
    img = _frames("u8", (2, 45, 61), 3)
    cfg = api.EdgeConfig(block_h=8, block_w=16)
    a = api.edge_detect(img, cfg.replace(plan=plan), device="cpu").magnitude
    b = api.edge_detect(img, cfg.replace(operator="sobel5"), device="cpu").magnitude
    assert torch.equal(a, b)
    # one-operator plans keep the operator's footprint and kernel packing
    assert ekern.window_smem_bytes(64, 256, 2, True, plan=plan) == ekern.window_smem_bytes(
        64, 256, 2, True)
    assert ekern._pack_pre(None, F.get_operator("sobel5"))[:2].tolist() == [0.0, 2.0]


def test_unported_lists_only_shard():
    """``shard`` was the last EdgeConfig field the engine refused as
    unported; since it runs, the table of unported fields is gone."""
    assert not hasattr(dispatch, "_UNPORTED")
    x = np.arange(2 * 9 * 11, dtype=np.uint8).reshape(2, 9, 11)
    cfg = api.EdgeConfig(plan="canny5", with_max=True)
    out = api.edge_detect(x, cfg.replace(shard=api.ShardConfig(data=1)), device="cpu")
    ref = api.edge_detect(x, cfg, device="cpu")
    assert torch.equal(out.magnitude, ref.magnitude) and torch.equal(out.peak, ref.peak)


def test_precision_resolution_takes_the_plan_chain():
    spec = F.get_operator("sobel5")
    kw = dict(spec=spec, rgb=False, input_dtype=torch.uint8)
    dil = carry(REF_PLANS["dilate_sobel5_nms"])
    assert dispatch.resolve_precision("auto", "cuda", plan=dil, **kw) == "int"
    assert dispatch.resolve_precision("auto", "torch", plan=dil, **kw) == "f32"
    assert dispatch.resolve_precision("auto", "cuda", plan=F.get_plan("canny5"), **kw) == "f32"
    with pytest.raises(ValueError, match="plan gate 'integer-taps'"):
        dispatch.resolve_precision("int", "cuda", plan=F.get_plan("canny5"), **kw)
    assert dispatch.resolve_precision("int", "torch", plan=dil, **kw) == "int"


def test_footprints_count_the_composed_reach_and_the_plane():
    canny = F.get_plan("canny5")
    # 74 x 266 f32 window + 70 x 262 blurred plane: 152,096 B, one CTA an SM
    want = 4 * 74 * 266 + 4 * 70 * 262
    assert ekern.pre_plane_words(64, 256, canny, True) == 70 * 262
    assert ekern.window_smem_bytes(64, 256, 2, True, plan=canny) == want
    assert ekern.window_smem_bytes(64, 256, 2, False, plan="blur_sobel5") == (
        4 * 72 * 264 + 4 * 68 * 260)
    # pointwise stages run in place: no plane
    ea = carry(REF_PLANS["erode_abs_sobel3"])
    assert ekern.pre_plane_words(8, 32, F.make_plan("a", (F.pointwise_stage("abs", "abs"), "sobel5")), False) == 0
    assert ekern.pre_plane_words(8, 32, ea, False) == (8 + 2) * (32 + 2)
    k2 = ekern.pipelined_smem_bytes(64, 256, 2, 2, 1, 1, True, plan=canny)
    assert k2 - ekern.pipelined_smem_bytes(64, 256, 4, 2, 1, 1, True) == 4 * 70 * 262
    # canny5's K2 ring fits u8 at depths 2 and 3 on 64x256, no f32 depth
    fits = [d for d in ekern.PIPELINE_DEPTHS for nb in (1, 4)
            if ekern.pipelined_smem_bytes(64, 256, 2, d, nb, 1, True, plan=canny)
            <= ekern.SMEM_MAX]
    assert fits == [2, 3]
    assert tuning.tile_fits(64, 256, canny.gradient, plan=canny)
    assert not tuning.tile_fits(64, 256, canny.gradient, depth=2, plan=canny)


def test_default_tile_sized_by_the_composed_reach(tmp_path):
    canny = F.get_plan("canny5")
    cache = tuning.TuningCache(str(tmp_path / "blocks.json"))
    assert dispatch.choose_block_shape(2048, 2048, plan=canny, cache=cache) == (
        *ekern.default_block_shape(2048, 2048, 9), 0, "default")


def test_plan_autotune_lands_in_plan_slot(tmp_path):
    cache = tuning.TuningCache(str(tmp_path / "blocks.json"))
    bh, bw, depth = tuning.autotune(32, 48, plan="canny5", backend="torch", shapes=[(8, 16)],
                                    iters=1, cache=cache, save=False)
    assert (bh, bw) == (8, 16) and depth in (0, 2)  # K1 or a depth-2 ring, the faster
    ident = F.plan_identity(F.get_plan("canny5"))
    key = tuning.TuneKey("torch", "float32", "sobel5", "v2", 32, 48, plan=ident)
    assert cache.lookup(key) == (8, 16, depth)
    assert cache.lookup(tuning.TuneKey("torch", "float32", "sobel5", "v2", 32, 48)) is None
    got = dispatch.choose_block_shape(32, 48, backend="torch", cache=cache,
                                      plan=F.get_plan("canny5"), nms=True)
    assert got == (8, 16, depth, "tuned")
    assert dispatch.choose_block_shape(32, 48, backend="torch", cache=cache)[3] == "default"


def test_sweep_times_the_fused_plan():
    rows = tuning.sweep(24, 40, plan="blur_sobel5", backend="torch", shapes=[(8, 16), (16, 32)],
                        iters=1)
    assert [(r["block_h"], r["block_w"]) for r in rows] == [(8, 16), (16, 32)]
    assert rows[0]["smem_bytes"] == ekern.window_smem_bytes(8, 16, 2, plan="blur_sobel5")


# ---------------------------------------------------------------------------
# Integer-lane bounds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(REF_PLANS))
def test_plan_bounds_equal_the_reference(name):
    ref = REF_PLANS[name]
    port = carry(ref)
    assert L.plan_input_bound(port) == RL.plan_input_bound(ref)
    assert L.plan_accum_dtype(port) == RL.plan_accum_dtype(ref)
    for rgb in (False, True):
        for dt in (np.uint8, np.float32):
            assert L.plan_int_eligible(port, rgb=rgb, input_dtype=dt) == RL.plan_int_eligible(
                ref, rgb=rgb, input_dtype=dt)
    assert L.plan_int_eligible(port, rgb=False, input_dtype=torch.uint8) == (
        RL.plan_int_eligible(ref, rgb=False, input_dtype=np.uint8))
    assert (name in INT_PLANS) == L.plan_int_eligible(port, rgb=False)[0]


def test_square_squares_the_bound():
    square = RF.pointwise_stage("square", "square")
    ref = RF.make_plan("sq2", (square, "sobel3"))
    port = carry(ref)
    assert L.plan_input_bound(port) == RL.plan_input_bound(ref) == (255.0 ** 2, "")
    big = RF.make_plan("sq4", (square, square, "sobel3"))
    assert L.plan_input_bound(carry(big)) == RL.plan_input_bound(big)
    assert L.plan_input_bound(carry(big))[0] is None


# ---------------------------------------------------------------------------
# Bit-exactness against the reference's XLA lane
# ---------------------------------------------------------------------------

def _variant(spec):
    return spec.resolve_variant("auto"), spec.resolve_directions(0)


@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("name", sorted(REF_PLANS))
def test_plan_components_and_thin_map_bit_exact(name, padding):
    ref = REF_PLANS[name]
    port = carry(ref)
    variant, directions = _variant(port.gradient)
    for i, (h, w) in enumerate(SIZES):
        img = _frames("f32", (2, h, w), 10 * i)
        comps = psobel.sobel_components(torch.from_numpy(img), plan=port, padding=padding,
                                       directions=directions, variant=variant)
        want = ref_sobel.sobel_components(jnp.asarray(img), plan=ref, padding=padding,
                                          directions=directions, variant=variant)
        for a, b in zip(comps, want):
            _eq(a, b, f"{name} {padding} {h}x{w} components")
        thin, tc, mag = pnms.thin_map(torch.from_numpy(img), port.gradient, variant=variant,
                                     directions=directions, padding=padding, plan=port)
        rthin, rtc, rmag = ref_nms.thin_map(jnp.asarray(img), ref.gradient, variant=variant,
                                            directions=directions, padding=padding, plan=ref)
        _eq(thin, rthin, f"{name} {padding} {h}x{w} thin")
        _eq(mag, rmag, f"{name} {padding} {h}x{w} mag")
        for a, b in zip(tc, rtc):
            _eq(a, b, f"{name} {padding} {h}x{w} centre components")


def test_plan_components_of_a_plan_without_gradient():
    ref = RF.make_plan("blur", ("gaussian5", "dilate3"))
    port = carry(ref)
    img = _frames("f32", (1, 23, 31), 4)
    ext, h, w = psobel._pad(torch.from_numpy(img), port.linear_reach, "reflect")
    rext, _, _ = ref_sobel._pad(jnp.asarray(img), ref.linear_reach, "reflect")
    (got,) = psobel.plan_components(ext, port, h, w, "v2", 4)
    (want,) = ref_sobel.plan_components(rext, ref, h, w, "v2", 4)
    _eq(got, want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("name", sorted(REF_PLANS))
def test_edge_detect_plan_matches_reference_xla(name, padding, kind):
    """The facade's plain lane equals the reference's XLA lane field by
    field, hysteresis included on NMS plans, at four sizes."""
    ref = REF_PLANS[name]
    port = carry(ref)
    for i, (h, w) in enumerate(SIZES):
        img = _frames(kind, (1, h, w), 100 * i + len(name))
        kw = dict(padding=padding, with_max=True, with_components=True, with_orientation=True,
                  hysteresis=ref.nms, normalize=i % 2 == 0)
        layout = "NHWC" if kind.startswith("rgb") else "NHW"
        got = api.edge_detect(img, api.EdgeConfig(plan=port, **kw), layout=layout, device="cpu")
        want = ref_api.edge_detect(img, ref_api.EdgeConfig(plan=ref, backend="xla", **kw),
                                   layout=layout)
        for f in ("magnitude", "components", "peak", "thin", "edges", "orientation"):
            a, b = getattr(got, f), getattr(want, f)
            assert (a is None) == (b is None), f
            if a is None:
                continue
            if f == "orientation":
                np.testing.assert_array_max_ulp(a.numpy(), np.asarray(b), maxulp=1)
            else:
                _eq(a, b, f"{name} {padding} {kind} {h}x{w} {f}")
        assert got.config.operator == want.config.operator == ref.gradient.name


@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("name", INT_PLANS)
def test_integer_lane_plans_equal_reference_and_f32(name, padding):
    ref = REF_PLANS[name]
    port = carry(ref)
    for i, (h, w) in enumerate(SIZES):
        img = _frames("u8", (2, h, w), 7 * i + 1)
        kw = dict(padding=padding, with_max=True, hysteresis=ref.nms, with_components=True)
        got = api.edge_detect(img, api.EdgeConfig(plan=port, precision="int", **kw),
                              layout="NHW", device="cpu")
        f32 = api.edge_detect(img, api.EdgeConfig(plan=port, precision="f32", **kw),
                              layout="NHW", device="cpu")
        want = ref_api.edge_detect(img, ref_api.EdgeConfig(plan=ref, backend="xla",
                                                           precision="int", **kw), layout="NHW")
        for f in ("magnitude", "components", "peak", "edges"):
            a, b = getattr(got, f), getattr(want, f)
            if a is None:
                continue
            _eq(a, b, f"{name} {padding} {h}x{w} {f}")
            assert torch.equal(a, getattr(f32, f)), f


@pytest.mark.parametrize("name", ("canny5", "blur_sobel5", "box3_erode_sobel3_nms"))
def test_plain_plan_is_tile_shape_invariant(name):
    port = carry(REF_PLANS[name])
    variant, directions = _variant(port.gradient)
    x = torch.from_numpy(_frames("f32", (2, 45, 70), 5))
    first = None
    for bh, bw in ((8, 16), (16, 70), (32, 32), (45, 70)):
        outs = ekern.edge_plain(x, plan=port, variant=variant, directions=directions,
                                block_h=bh, block_w=bw, out_nms=port.nms, out_mag=port.nms,
                                with_max=True)
        maps, bmax = outs[:-1], outs[-1]
        first = first or maps
        for a, b in zip(maps, first):
            assert torch.equal(a, b), (bh, bw)
        assert torch.equal(bmax, ekern._block_max(maps[-1], bh, bw)), (bh, bw)


@pytest.mark.parametrize("padding", PADDINGS)
def test_composed_extension_matches_textbook_staging_interior(padding):
    """Padding the input once by the composed reach equals staging each
    stage with its own pad at every interior pixel, and differs in the
    border band (a reflected blurred plane is not the blur of the reflected
    input)."""
    img = torch.from_numpy(_frames("u8", (1, 48, 57), 6)).to(torch.float32)
    plan = F.get_plan("blur_sobel5")
    blur = plan.pre_stages[0]
    ext, h, w = psobel._pad(img, blur.radius, padding)
    blurred = psobel._stage_apply(ext, blur, h, w)
    ext2, _, _ = psobel._pad(blurred, plan.gradient.radius, padding)
    staged = psobel.magnitude(psobel.spec_components(ext2, plan.gradient, h, w, "v2", 4))
    fused = api.edge_detect(img, api.EdgeConfig(plan=plan, padding=padding, normalize=False),
                            device="cpu").magnitude
    r = plan.linear_reach
    assert torch.equal(fused[:, r:-r, r:-r], staged[:, r:-r, r:-r])
    # Reflection commutes with the symmetric blur; replication and zeros do not.
    assert torch.equal(fused, staged) == (padding == "reflect")


# ---------------------------------------------------------------------------
# chip_smoke.py's plan phases: their constants against the reference
# ---------------------------------------------------------------------------

def _chip_smoke():
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_plan_digests_are_the_references():
    """chip_smoke.py holds the card's plan facade against digests of the JAX
    reference's output; recompute them here, and check the port's CPU lane
    gives the same bytes."""
    cs = _chip_smoke()
    for (plan, name), fields in cs.PLAN_GOLDEN.items():
        arr = cs.golden_inputs()[name]
        kw = dict(plan=plan, with_max=True, hysteresis=plan == "canny5")
        ref = ref_api.edge_detect(arr, ref_api.EdgeConfig(backend="xla", **kw))
        res = api.edge_detect(arr, api.EdgeConfig(**kw), device="cpu")
        for field, want in fields.items():
            assert cs.digest(torch.from_numpy(np.array(getattr(ref, field)))) == want
            assert cs.digest(getattr(res, field)) == want


def test_chip_smoke_battery_is_the_tests_plans():
    cs = _chip_smoke()
    battery = cs.plan_battery()
    assert sorted(battery) == sorted(REF_PLANS) and cs.INT_PLANS == INT_PLANS
    for name, plan in battery.items():
        assert F.plan_identity(plan) == RF.plan_identity(REF_PLANS[name])
        assert plan == carry(REF_PLANS[name])


def test_chip_smoke_counts_the_plan_operations():
    """The bound's pre-stage operations: Gaussian5 separable is 2 x (5 + 4)
    = 18 a pixel of the blurred plane, over the frame extended by the
    gradient's radius (+ NMS's ring); the 9x9 yardstick bank gives
    blur_sobel5's components."""
    cs = _chip_smoke()
    canny, blur = F.get_plan("canny5"), F.get_plan("blur_sobel5")
    assert cs.stage_ops(canny.pre_stages[0]) == 18
    assert cs.plan_pre_ops(canny, 4, 2048, 2048, True) == 4 * 2054 * 2054 * 18
    assert cs.plan_pre_ops(blur, 1, 10, 20, False) == 14 * 24 * 18
    assert cs.stage_ops(F.get_stage("dilate3")) == 4
    bank = cs.composed_bank(blur)
    assert bank.shape == (4, 9, 9)
    img = torch.from_numpy(_frames("f32", (1, 30, 41), 8))
    comps = torch.stack(psobel.sobel_components(img, plan=blur), dim=1)
    xp = torch.nn.functional.pad(img[:, None].double(), (4, 4, 4, 4), mode="reflect")
    conv = torch.nn.functional.conv2d(xp, torch.from_numpy(bank).double()[:, None])
    torch.testing.assert_close(conv.float(), comps, rtol=1e-5, atol=1e-3)
