"""The exact integer lane of the port against the reference's XLA lane.

``sobel_components(precision="int")``, ``thin_map(precision="int")`` and
``edge_detect(..., precision="int")`` on the CPU must equal the reference's
``precision="int"`` XLA lane and the port's own f32 lane bit for bit, for
every int-eligible operator x variant x directions x padding. The
``resolve_precision`` table and its errors must match the reference's, with
``cuda`` in the place of ``pallas-tpu`` and ``torch`` in that of ``xla``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import EdgeConfig as RefConfig
from repro.api import edge_detect as ref_edge_detect
from repro.core import filters as RF
from repro.core import nms as RN
from repro.core.sobel import sobel_components as ref_sobel_components
from repro.kernels import dispatch as ref_dispatch
from repro_torch.api import EdgeConfig, edge_detect
from repro_torch.core import filters as TF
from repro_torch.core import nms as TN
from repro_torch.core import sobel as TS
from repro_torch.kernels import dispatch
from repro_torch.kernels import edge as ekern

INT_OPERATORS = ("prewitt3", "scharr3", "sobel3", "sobel5", "sobel7")
PADDINGS = ("reflect", "edge", "zero")
SHAPES = ((1, 1), (2, 3), (5, 7), (37, 53))


def _u8(shape, seed=7):
    return np.random.default_rng(seed).integers(0, 256, (2,) + shape).astype(np.uint8)


def _ladders(name):
    spec = TF.get_operator(name)
    for variant in spec.variants:
        for d in spec.directions:
            yield spec, variant, d


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("name", INT_OPERATORS)
def test_int_components_match_reference_and_f32(name, padding, shape):
    img = _u8(shape)
    for spec, variant, d in _ladders(name):
        kw = dict(operator=name, variant=variant, directions=d, padding=padding)
        ref = ref_sobel_components(jnp.asarray(img), precision="int", **kw)
        got = TS.sobel_components(torch.from_numpy(img), precision="int", **kw)
        f32 = TS.sobel_components(torch.from_numpy(img), precision="f32", **kw)
        assert len(got) == len(ref) == d
        for g, r, f in zip(got, ref, f32):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
            assert torch.equal(g, f)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("name", INT_OPERATORS)
def test_int_thin_map_matches_reference_and_f32(name, padding, shape):
    img = _u8(shape, seed=8)
    for spec, variant, d in _ladders(name):
        kw = dict(variant=variant, directions=d, padding=padding)
        ref = RN.thin_map(jnp.asarray(img), RF.get_operator(name), precision="int", **kw)
        got = TN.thin_map(torch.from_numpy(img), spec, precision="int", **kw)
        f32 = TN.thin_map(torch.from_numpy(img), spec, **kw)
        (gt, gc, gm), (rt, rc, rm), (ft, fc, fm) = got, ref, f32
        np.testing.assert_array_equal(gt.numpy(), np.asarray(rt))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(rm))
        for g, r in zip(gc, rc):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        assert torch.equal(gt, ft) and torch.equal(gm, fm)
        assert all(torch.equal(g, f) for g, f in zip(gc, fc))


@pytest.mark.parametrize("nms", (False, True))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", INT_OPERATORS)
def test_int_facade_matches_reference_and_f32(name, shape, nms):
    img = _u8(shape, seed=9)
    for padding in PADDINGS:
        cfg = dict(operator=name, padding=padding, nms=nms, with_max=True,
                   with_components=True)
        ref = ref_edge_detect(img, RefConfig(backend="xla", precision="int", **cfg),
                              layout="NHW")
        got = edge_detect(img, EdgeConfig(precision="int", **cfg), layout="NHW", device="cpu")
        f32 = edge_detect(img, EdgeConfig(precision="f32", **cfg), layout="NHW", device="cpu")
        for field in ("magnitude", "components", "peak"):
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(ref, field)))
            assert torch.equal(getattr(got, field), getattr(f32, field))


@pytest.mark.parametrize("depth", (0, 2, 8))
def test_int_plain_kernel_lane_equals_f32(depth):
    """``edge_plain``, the plain version of K1 and K2, on the integer lane:
    every output equals the f32 lane's, at any ring depth."""
    x = torch.from_numpy(_u8((37, 53), seed=10))
    for name in INT_OPERATORS:
        for spec, variant, d in _ladders(name):
            for extra in (dict(with_max=True), dict(out_components=True, with_max=True),
                          dict(out_nms=True, out_components=True, out_mag=True, with_max=True)):
                kw = dict(spec=spec, variant=variant, directions=d, block_h=16, block_w=32,
                          **extra)
                a = ekern.edge_plain(x, precision="int", pipeline_depth=depth, **kw)
                b = ekern.edge_plain(x, **kw)
                assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_int_lane_refuses_what_the_reference_refuses():
    u8 = _u8((5, 7))
    rgb = np.random.default_rng(3).integers(0, 256, (5, 7, 3)).astype(np.uint8)
    for image in (u8.astype(np.float32), rgb):
        with pytest.raises(ValueError) as ref_err:
            ref_edge_detect(image, RefConfig(backend="xla", precision="int"))
        with pytest.raises(ValueError) as got_err:
            edge_detect(image, EdgeConfig(precision="int"), device="cpu")
        assert str(got_err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="not uint8"):
        TS.sobel_components(torch.zeros((4, 4)), precision="int")
    with pytest.raises(ValueError, match="unknown precision"):
        TS.sobel_components(torch.zeros((4, 4)), precision="fp8")
    spec = TF.get_operator("sobel5")
    with pytest.raises(ValueError, match="RGB input"):
        ekern.edge_plain(torch.zeros((1, 4, 4, 3), dtype=torch.uint8), spec=spec,
                         variant="v2", directions=4, rgb=True, precision="int")
    with pytest.raises(ValueError, match="unknown precision"):
        ekern.edge_plain(torch.zeros((1, 4, 4), dtype=torch.uint8), spec=spec,
                         variant="v2", directions=4, precision="auto")


# Backend names: the port's -> the reference's counterpart.
BACKENDS = {"cuda": "pallas-tpu", "torch": "xla"}
FRACTIONAL = ((0.25, 0.5, 0.25), (-1.0, 0.0, 1.0))


def _spec_pair(name):
    if name == "binomial3":
        return (TF.make_separable_spec(name, *FRACTIONAL),
                RF.make_separable_spec(name, *FRACTIONAL))
    return TF.get_operator(name), RF.get_operator(name)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("precision", ("auto", "f32", "int", "fp16"))
@pytest.mark.parametrize("name", ("sobel5", "sobel3", "binomial3"))
def test_resolve_precision_table_matches_reference(name, precision, backend):
    port, ref = _spec_pair(name)
    for rgb in (False, True):
        for dtype in ("uint8", "float32"):
            kw = dict(rgb=rgb)
            try:
                want = ref_dispatch.resolve_precision(
                    precision, BACKENDS[backend], spec=ref, input_dtype=np.dtype(dtype), **kw)
            except ValueError as e:
                with pytest.raises(ValueError) as err:
                    dispatch.resolve_precision(precision, backend, spec=port,
                                               input_dtype=getattr(torch, dtype), **kw)
                assert str(err.value) == str(e)
                continue
            got = dispatch.resolve_precision(precision, backend, spec=port,
                                             input_dtype=getattr(torch, dtype), **kw)
            assert got == want


def test_auto_takes_the_int_lane_on_cuda_only():
    spec = TF.get_operator("sobel5")
    kw = dict(spec=spec, rgb=False, input_dtype=torch.uint8)
    assert dispatch.resolve_precision("auto", "cuda", **kw) == "int"
    assert dispatch.resolve_precision("auto", "torch", **kw) == "f32"
    assert dispatch.resolve_precision("auto", "cuda", spec=spec, rgb=True,
                                      input_dtype=torch.uint8) == "f32"
    assert dispatch.resolve_precision("auto", "cuda", spec=spec, rgb=False,
                                      input_dtype=torch.float32) == "f32"
