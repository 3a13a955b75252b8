"""The port's facade against the reference's XLA lane.

``repro_torch.api.edge_detect(..., device="cpu")`` runs the plain lane and
must equal ``repro.api.edge_detect(..., EdgeConfig(backend="xla"))`` bit for
bit in every layout, input type and output selection. The one exception is
``orientation``: ``torch.atan2`` and ``jnp.arctan2`` may differ by 1 ulp, so
it is held to ``maxulp=1``.
"""
import numpy as np
import pytest
import torch

from repro.api import EdgeConfig as RefConfig
from repro.api import edge_detect as ref_edge_detect
from repro_torch.api import LAYOUTS, EdgeConfig, detect_layout, edge_detect
from repro_torch.kernels import dispatch

INPUTS = (
    ("HW", "u8", (23, 37)),
    ("HW", "f32", (23, 37)),
    ("HWC", "u8", (23, 37, 3)),
    ("NHW", "u8", (2, 19, 29)),
    ("NHW", "f32", (2, 19, 29)),
    ("NHWC", "u8", (2, 19, 29, 3)),
    ("NHWC", "f32", (2, 19, 29, 3)),
    ("NTHW", "u8", (2, 2, 13, 17)),
    ("NTHW", "f32", (2, 2, 13, 17)),
    ("NTHWC", "u8", (2, 2, 13, 17, 3)),
)
CONFIGS = {
    "default": {},
    "raw": dict(normalize=False),
    "all-outputs": dict(with_components=True, with_max=True, with_orientation=True),
    "all-outputs-raw": dict(normalize=False, with_components=True, with_max=True,
                            with_orientation=True),
}


def _frames(dtype, shape):
    rng = np.random.default_rng(sum(shape))
    if dtype == "u8":
        return rng.integers(0, 256, shape).astype(np.uint8)
    noisy = rng.uniform(0, 255, shape) + rng.normal(0, 2, shape)
    return np.clip(noisy, 0, 255).astype(np.float32)


def _assert_result_matches(res, ref):
    assert res.layout == ref.layout
    for field in ("magnitude", "components", "peak", "orientation"):
        a, b = getattr(ref, field), getattr(res, field)
        if a is None:
            assert b is None, field
            continue
        a, b = np.asarray(a), b.numpy()
        assert b.shape == a.shape and b.dtype == a.dtype, field
        if field == "orientation":
            np.testing.assert_array_max_ulp(b, a, maxulp=1)
        else:
            np.testing.assert_array_equal(b, a, err_msg=field)


@pytest.mark.parametrize("config", CONFIGS, ids=str)
@pytest.mark.parametrize("layout,dtype,shape", INPUTS, ids=[f"{l}-{d}" for l, d, _ in INPUTS])
def test_edge_detect_matches_reference_xla(layout, dtype, shape, config):
    x = _frames(dtype, shape)
    ref = ref_edge_detect(x, RefConfig(backend="xla", **CONFIGS[config]))
    res = edge_detect(x, EdgeConfig(**CONFIGS[config]), device="cpu")
    assert res.layout == layout
    _assert_result_matches(res, ref)


@pytest.mark.parametrize("operator,variant,padding", (
    ("sobel3", "auto", "edge"), ("scharr3", "direct", "zero"),
    ("prewitt3", "separable", "reflect"), ("sobel7", "auto", "zero"),
    ("sobel5", "v1", "edge"), ("sobel5", "direct", "reflect"),
))
def test_operators_through_the_facade(operator, variant, padding):
    x = _frames("f32", (2, 21, 34))
    kw = dict(operator=operator, variant=variant, padding=padding, with_max=True,
              with_components=True)
    ref = ref_edge_detect(x, RefConfig(backend="xla", **kw))
    res = edge_detect(x, EdgeConfig(**kw), device="cpu", block_h=8, block_w=16)
    _assert_result_matches(res, ref)
    assert res.config.variant == ref.config.variant
    assert res.config.directions == ref.config.directions


def test_tensor_input_and_layout_override():
    x = _frames("u8", (2, 12, 3))  # a gray batch of 3-pixel-wide frames reads as HWC
    ref = ref_edge_detect(x, RefConfig(backend="xla"), layout="NHW")
    res = edge_detect(torch.from_numpy(x), layout="NHW", device="cpu")
    _assert_result_matches(res, ref)
    assert detect_layout(x.shape) == "HWC"


def test_detect_layout_matches_reference():
    from repro.api import detect_layout as ref_detect_layout

    for shape in ((4, 5), (4, 5, 3), (2, 4, 5), (2, 4, 5, 3), (2, 3, 4, 5), (2, 3, 4, 5, 3),
                  (2, 2, 3, 4, 5)):
        assert detect_layout(shape) == ref_detect_layout(shape)
    assert set(LAYOUTS) == {detect_layout(s) for s in
                            ((4, 5), (4, 5, 3), (2, 4, 5), (2, 4, 5, 3), (2, 3, 4, 5),
                             (2, 3, 4, 5, 3))}


def test_no_device_means_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the no-card path is what is tested")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        edge_detect(np.zeros((8, 8), np.uint8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        edge_detect(np.zeros((8, 8), np.uint8), device="cuda")


def test_backends_resolve_by_device():
    cpu = torch.device("cpu")
    assert dispatch.resolve_backend(None, cpu) == "torch"
    assert dispatch.resolve_backend("auto", cpu) == "torch"
    assert dispatch.resolve_backend("torch", cpu) == "torch"
    assert dispatch.resolve_backend("auto", torch.device("cuda")) == "cuda"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        dispatch.resolve_backend("cuda", cpu)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        edge_detect(np.zeros((8, 8), np.uint8), backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        edge_detect(np.zeros((8, 8), np.uint8), backend="xla", device="cpu")
    from repro_torch.core.filters import get_operator

    spec = get_operator("sobel5")
    assert dispatch.resolve_precision("auto", "torch", spec=spec, rgb=False,
                                      input_dtype=torch.uint8) == "f32"


@pytest.mark.parametrize("spec", ("1x1x1", "auto", "0x1x1"))
def test_shard_is_accepted(spec):
    """``EdgeConfig.shard`` runs (it raised while sharding was unported): on
    the CPU its mesh is the one CPU device, so the call equals the
    unsharded one; a spatial grid that does not fit raises the reference's
    error."""
    from repro_torch.api import ShardConfig

    x = _frames("u8", (2, 19, 29))
    ref = edge_detect(x, device="cpu", with_max=True)
    out = edge_detect(x, device="cpu", with_max=True, shard=ShardConfig.parse(spec))
    np.testing.assert_array_equal(out.magnitude.numpy(), ref.magnitude.numpy())
    np.testing.assert_array_equal(out.peak.numpy(), ref.peak.numpy())
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        edge_detect(x, device="cpu", shard=ShardConfig(rows=2, cols=2))


def test_config_validation_matches_reference():
    for bad in (dict(precision="fp8"), dict(pipeline_depth=9), dict(decay=0.5),
                dict(low=0.3), dict(hysteresis=True, low=0.5, high=0.2),
                dict(variant="v9"), dict(directions=3)):
        with pytest.raises(ValueError):
            RefConfig(**bad).resolved()
        with pytest.raises(ValueError):
            EdgeConfig(**bad).resolved()
    cfg = EdgeConfig().resolved()
    ref = RefConfig().resolved()
    assert (cfg.operator, cfg.directions, cfg.variant, cfg.padding, cfg.normalize) == (
        ref.operator, ref.directions, ref.variant, ref.padding, ref.normalize)
    assert cfg.resolved() == cfg


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_golden_digests_are_the_references():
    """chip_smoke.py holds the card's facade output against digests of the
    JAX reference's output; recompute them here, and check the port's CPU
    lane produces the same bytes."""
    cs = _chip_smoke()
    for name, arr in cs.golden_inputs().items():
        ref = ref_edge_detect(arr, RefConfig(backend="xla", with_max=True))
        res = edge_detect(arr, EdgeConfig(with_max=True), device="cpu")
        for field in ("magnitude", "peak"):
            want = cs.GOLDEN[name][field]
            assert cs.digest(torch.from_numpy(np.array(getattr(ref, field)))) == want
            assert cs.digest(getattr(res, field)) == want


def test_chip_smoke_counts_the_ladder_operations():
    """The bound's operation count for the main path: sobel5, v2, 4 directions."""
    from repro_torch.core.filters import get_operator

    cs = _chip_smoke()
    spec = get_operator("sobel5")
    # F 5, S 7, Gx 7, Gy 5, K_d+ 2 passes x 9 + 3, D 1, v2 col passes 9 + 5 + 1,
    # halving 4, magnitude 8.
    assert cs.kernel_ops_per_pixel(spec, "v2", 4, rgb=False) == 73
    assert cs.kernel_ops_per_pixel(spec, "v2", 4, rgb=True) == 78


def test_chip_smoke_bounds_the_nms_lane_and_k3():
    """The NMS lane's operations and K3's bound on a mask: the ladder runs
    once per pixel whose magnitude a changed tile needs (its pixels and its
    one-pixel ring, each counted once), the sector and suppression once per
    changed pixel."""
    from repro_torch.core.filters import get_operator

    cs = _chip_smoke()
    spec = get_operator("sobel5")
    assert cs.nms_ops_per_pixel(4) == 12 and cs.nms_ops_per_pixel(2) == 10
    px = cs.tile_pixels(5, 7, 2, 4)
    assert px.tolist() == [[8, 6], [8, 6], [4, 3]] and px.sum() == 35
    mask = np.zeros((1, 3, 2), np.int32)
    ones = np.ones_like(mask)
    # Every tile changed: the (H+2)(W+2) extended frame, whatever the tiles.
    assert cs.magnitude_pixels(ones, 5, 7, 2, 4) == 7 * 9
    assert cs.magnitude_pixels(np.ones((2, 1, 1)), 5, 7, 5, 7) == 2 * 7 * 9
    assert cs.magnitude_pixels(mask, 5, 7, 2, 4) == 0
    one = mask.copy()
    one[0, 0, 0] = 1            # rows -1..2, cols -1..4
    assert cs.magnitude_pixels(one, 5, 7, 2, 4) == 4 * 6
    one[0, 0, 1] = 1            # its right neighbour: cols -1..7, one ring shared
    assert cs.magnitude_pixels(one, 5, 7, 2, 4) == 4 * 9
    assert cs.nms_lane_ops(spec, "v2", 4, False, one, 5, 7, 2, 4) == 73 * 36 + 12 * 14
    assert cs.nms_lane_ops(spec, "v2", 4, True, ones, 5, 7, 2, 4) == 73 * 63 + 17 * 35
    t_none = cs.stream_bound(mask, 5, 7, 2, 4, 1, 0)
    assert t_none[4] == 0.0 and t_none[1] == "bytes"
    # Nothing changed: read and write 4 B/px, the mask and the maxima.
    assert t_none[2] == pytest.approx((35 * 8 + 6 * 8 + 6 * 4) / cs.HBM_BYTES_PER_S * 1e3)
    ops = cs.nms_lane_ops(spec, "v2", 4, False, ones, 5, 7, 2, 4)
    t_all = cs.stream_bound(ones, 5, 7, 2, 4, 1, ops)
    assert t_all[4] == 1.0
    assert t_all[3] == pytest.approx((73 * 63 + 12 * 35) / cs.F32_OPS_PER_S * 1e3)
