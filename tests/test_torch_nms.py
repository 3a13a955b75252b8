"""NMS and hysteresis of the port against the reference, bit for bit.

Every function of ``repro_torch.core.nms`` is held against its counterpart
in ``repro.core.nms``; K1's plain version with ``out_nms`` against
``repro.core.nms.thin_map``; and ``edge_detect(nms=..., hysteresis=...)``
against ``repro.api.edge_detect(backend="xla")``, the reference's lane that
runs on this host. Inputs are made from a seed with numpy.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import EdgeConfig as RefConfig
from repro.api import edge_detect as ref_edge_detect
from repro.core.pipeline import rgb_to_gray as ref_rgb_to_gray
from repro_torch.api import EdgeConfig, edge_detect
from repro_torch.core import nms
from repro_torch.core.filters import get_operator
from repro_torch.kernels import edge as ekern

RN = importlib.import_module("repro.core.nms")
RF = importlib.import_module("repro.core.filters")

SHAPES = ((1, 1), (2, 3), (5, 7), (37, 53))
OPERATORS = ("sobel3", "sobel5", "scharr3", "sobel7")


def _frames(kind, shape, seed=5):
    rng = np.random.default_rng(seed)
    if kind == "u8":
        return rng.integers(0, 256, shape).astype(np.uint8)
    if kind == "f32":
        noisy = rng.uniform(0, 255, shape) + rng.normal(0, 2, shape)
        return np.clip(noisy, 0, 255).astype(np.float32)
    return rng.integers(0, 256, tuple(shape) + (3,)).astype(np.uint8)


def _eq(got, want, what=""):
    np.testing.assert_array_equal(got.numpy() if isinstance(got, torch.Tensor) else got,
                                  np.asarray(want), err_msg=what)


@pytest.mark.parametrize("n", (2, 4))
def test_nms_sector_matches_reference(n):
    rng = np.random.default_rng(n)
    # Small integers make ties and sign flips common; add fractional values too.
    comps = [np.concatenate([rng.integers(-3, 4, 400), rng.normal(0, 50, 400)]).astype(np.float32)
             for _ in range(n)]
    comps[0][:3] = (0.0, -0.0, 1.0)
    got = nms.nms_sector(tuple(torch.from_numpy(c) for c in comps))
    want = RN.nms_sector(tuple(jnp.asarray(c) for c in comps))
    assert got.dtype == torch.int32
    _eq(got, want)


def test_nms_sector_two_directions_uses_the_f32_boundary():
    assert nms.TAN_PI8_F32 == np.float32(RN._TAN_PI8)
    assert nms.TAN_PI8_F32.dtype == np.float32
    t = float(nms.TAN_PI8_F32)
    gx = np.array([1.0, 1.0, 1.0, -2.0], np.float32)
    gy = np.array([t, np.nextafter(np.float32(t), np.float32(1)), 0.9, 2.0], np.float32)
    got = nms.nms_sector((torch.from_numpy(gx), torch.from_numpy(gy)))
    _eq(got, RN.nms_sector((jnp.asarray(gx), jnp.asarray(gy))))
    assert got.tolist()[:2] == [0, 2]


def test_nms_thin_matches_reference():
    rng = np.random.default_rng(3)
    mag_ext = rng.integers(0, 5, (2, 11, 13)).astype(np.float32)
    sector = rng.integers(0, 4, (2, 9, 11)).astype(np.int32)
    got = nms.nms_thin(torch.from_numpy(mag_ext), torch.from_numpy(sector))
    _eq(got, RN.nms_thin(jnp.asarray(mag_ext), jnp.asarray(sector)))


@pytest.mark.parametrize("kind", ("u8", "f32", "rgb"))
@pytest.mark.parametrize("padding", ("reflect", "edge", "zero"))
@pytest.mark.parametrize("op", OPERATORS)
def test_thin_map_matches_reference(op, padding, kind):
    spec, ref_spec = get_operator(op), RF.get_operator(op)
    for directions in spec.directions:
        variant = spec.resolve_variant("auto")
        for shape in SHAPES:
            x = _frames(kind, (2,) + shape)
            gray = np.asarray(ref_rgb_to_gray(x)) if kind == "rgb" else x.astype(np.float32)
            want = RN.thin_map(jnp.asarray(gray), ref_spec, variant=variant,
                               directions=directions, padding=padding)
            got = nms.thin_map(torch.from_numpy(gray), spec, variant=variant,
                               directions=directions, padding=padding)
            what = f"{op} {directions} {padding} {kind} {shape}"
            _eq(got[0], want[0], what)
            for g, w in zip(got[1], want[1]):
                _eq(g, w, what)
            _eq(got[2], want[2], what)


@pytest.mark.parametrize("block", ((8, 8), (5, 7), (16, 32)), ids=lambda b: f"{b[0]}x{b[1]}")
@pytest.mark.parametrize("kind", ("u8", "f32", "rgb"))
def test_edge_plain_nms_outputs_match_reference(kind, block):
    """K1's plain version with out_nms: thin map, centre components,
    un-thinned magnitude and per-tile max, in the reference's order."""
    spec, ref_spec = get_operator("sobel5"), RF.get_operator("sobel5")
    x = _frames(kind, (2, 37, 53))
    gray = np.asarray(ref_rgb_to_gray(x)) if kind == "rgb" else x.astype(np.float32)
    thin, comps, mag = RN.thin_map(jnp.asarray(gray), ref_spec, variant="v2", directions=4)
    mag = np.asarray(mag)
    outs = ekern.edge_plain(torch.from_numpy(x), spec=spec, variant="v2", directions=4,
                            block_h=block[0], block_w=block[1], rgb=kind == "rgb",
                            out_nms=True, out_components=True, out_mag=True, with_max=True)
    assert len(outs) == 4
    _eq(outs[0], thin)
    _eq(outs[1], np.stack([np.asarray(c) for c in comps], axis=1))
    _eq(outs[2], mag)
    bh, bw = block
    gh, gw = -(-37 // bh), -(-53 // bw)
    want_max = np.zeros((2, gh, gw), np.float32)
    for k in range(gh):
        for j in range(gw):
            want_max[:, k, j] = mag[:, k * bh:(k + 1) * bh, j * bw:(j + 1) * bw].max(axis=(1, 2))
    _eq(outs[3], want_max)
    only_thin = ekern.edge_plain(torch.from_numpy(x), spec=spec, variant="v2", directions=4,
                                 rgb=kind == "rgb", out_nms=True)
    assert isinstance(only_thin, torch.Tensor)
    _eq(only_thin, thin)


def test_out_mag_needs_out_nms():
    x = torch.zeros((1, 8, 8))
    with pytest.raises(ValueError, match="out_mag"):
        ekern.edge_plain(x, spec=get_operator("sobel5"), variant="v2", directions=4,
                         out_mag=True)


def _thin_maps(seed=9, shape=(3, 29, 31)):
    """Thin-map-like inputs: sparse random values, and an isolated ridge of
    weak values (between 10% and 20% of the peak 100) with a strong end at
    column 28, which links only through 26 dilation steps."""
    rng = np.random.default_rng(seed)
    thin = rng.uniform(0, 100, shape).astype(np.float32)
    thin[rng.uniform(size=shape) < 0.45] = 0.0
    thin[:, :, 0] = 100.0
    thin[:, 5:10, :] = 0.0
    thin[:, 7, 2:28] = np.linspace(12, 18, 26, dtype=np.float32)
    thin[:, 7, 28] = 90.0
    thin[1] = 0.0
    return thin


def test_resolve_thresholds_matches_reference():
    peak = np.array([[[0.0]], [[173.25]], [[1e-3]]], np.float32)
    for low, high in ((None, None), (0.05, 0.3), (0.1, 0.1)):
        got = nms.resolve_thresholds(torch.from_numpy(peak), low, high)
        want = RN.resolve_thresholds(jnp.asarray(peak), low, high)
        for g, w in zip(got, want):
            _eq(g, w)


def test_dilate8_matches_reference():
    m = np.random.default_rng(1).uniform(size=(2, 9, 12)) < 0.1
    _eq(nms._dilate8(torch.from_numpy(m)), RN._dilate8(jnp.asarray(m)))
    _eq(nms._dilate8(torch.ones((1, 1), dtype=torch.bool)), np.ones((1, 1), bool))


@pytest.mark.parametrize("max_burst", (1, 3, 64))
@pytest.mark.parametrize("seeded", (False, True))
def test_hysteresis_matches_reference(seeded, max_burst, monkeypatch):
    monkeypatch.setattr(nms, "MAX_BURST", max_burst)
    thin = _thin_maps()
    peak = thin.max(axis=(1, 2), keepdims=True)
    lo, hi = RN.resolve_thresholds(jnp.asarray(peak))
    seed = None
    if seeded:
        seed = np.random.default_rng(4).uniform(size=thin.shape) < 0.05
    want = RN.hysteresis(jnp.asarray(thin), lo, hi,
                         seed=None if seed is None else jnp.asarray(seed))
    got = nms.hysteresis(torch.from_numpy(thin), torch.from_numpy(np.asarray(lo)),
                         torch.from_numpy(np.asarray(hi)),
                         seed=None if seed is None else torch.from_numpy(seed))
    assert got.dtype == torch.bool
    _eq(got, want)
    # The ridge needs 26 linking steps; bursts may overshoot the fixpoint.
    assert nms.hysteresis.iterations >= 26
    # A weak ridge attached to a strong end links along its whole length.
    assert bool(got[0, 7, 2:29].all()) and not bool(got[1].any())


def test_temporal_seeds_and_update_match_reference():
    rng = np.random.default_rng(2)
    strength = rng.choice(np.array([0.0, 0.3, 0.6, 1.0], np.float32), size=(2, 6, 7))
    edges = rng.uniform(size=(2, 6, 7)) < 0.3
    for decay in (0.0, 0.6, 0.9, 1.0):
        seed, decayed = nms.temporal_seeds(torch.from_numpy(strength), decay)
        rseed, rdecayed = RN.temporal_seeds(jnp.asarray(strength), decay)
        _eq(seed, rseed)
        _eq(decayed, rdecayed)
        _eq(nms.update_seed_strength(decayed, torch.from_numpy(edges)),
            RN.update_seed_strength(rdecayed, jnp.asarray(edges)))
    assert (nms.DEFAULT_LOW, nms.DEFAULT_HIGH, nms.TEMPORAL_FLOOR) == (
        RN.DEFAULT_LOW, RN.DEFAULT_HIGH, RN.TEMPORAL_FLOOR)


@pytest.mark.parametrize("kind", ("u8", "f32", "rgb"))
@pytest.mark.parametrize("padding", ("reflect", "edge", "zero"))
@pytest.mark.parametrize("op", OPERATORS)
def test_edge_detect_hysteresis_matches_reference(op, padding, kind):
    spec = get_operator(op)
    for directions in spec.directions:
        for shape in SHAPES:
            x = _frames(kind, (2,) + shape, seed=len(shape) + directions)
            kw = dict(operator=op, directions=directions, padding=padding, hysteresis=True,
                      with_max=True)
            want = ref_edge_detect(x, RefConfig(backend="xla", **kw))
            got = edge_detect(x, EdgeConfig(**kw), device="cpu")
            for field in ("magnitude", "thin", "edges", "peak"):
                _eq(getattr(got, field), getattr(want, field),
                    f"{op} {directions} {padding} {kind} {shape} {field}")


@pytest.mark.parametrize("config", (
    dict(nms=True),
    dict(nms=True, normalize=False, with_components=True, with_orientation=True),
    dict(hysteresis=True, low=0.05, high=0.3, normalize=False),
    dict(hysteresis=True, operator="sobel3", variant="direct", directions=2),
    dict(nms=True, with_max=True, block_h=8, block_w=16),
), ids=str)
def test_edge_detect_nms_configs_match_reference(config):
    for x in (_frames("u8", (3, 37, 53)), _frames("rgb", (2, 2, 21, 19)),
              _frames("f32", (37, 53))):
        want = ref_edge_detect(x, RefConfig(backend="xla", **config))
        got = edge_detect(x, EdgeConfig(**config), device="cpu")
        for field in ("magnitude", "components", "orientation", "peak", "thin", "edges"):
            a, b = getattr(got, field), getattr(want, field)
            assert (a is None) == (b is None), field
            if a is None:
                continue
            if field == "orientation":
                # atan2 agrees within 1 ulp between the two libraries.
                np.testing.assert_array_max_ulp(a.numpy(), np.asarray(b), maxulp=1)
            else:
                _eq(a, b, field)


def test_stateless_path_rejects_temporal():
    """edge_detect refuses temporal hysteresis, as the reference does: the
    seeds are per-stream state."""
    for detect, cfg, kw in ((edge_detect, EdgeConfig, dict(device="cpu")),
                            (ref_edge_detect, RefConfig, {})):
        with pytest.raises(ValueError, match="temporal"):
            detect(np.zeros((8, 8), np.uint8), cfg(temporal=True, backend=None), **kw)
