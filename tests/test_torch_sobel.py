"""The port's plain variant ladder equals the reference's, bit for bit.

Every operator x supported variant x direction count x padding, on tiny,
sub-stencil and ragged shapes, for gray u8, fractional gray f32 (the
server's ``image_batch`` frames carry Gaussian noise) and RGB u8 frames
through ``rgb_to_gray``. Fractional inputs make the f32 operation order
part of the result, so the comparison is ``assert_array_equal``.
"""
import functools
import importlib

import numpy as np
import pytest
import torch

from repro.core import filters as RF
from repro.core.pipeline import rgb_to_gray as ref_rgb_to_gray
from repro_torch.core.pipeline import rgb_to_gray

RS = importlib.import_module("repro.core.sobel")
TS = importlib.import_module("repro_torch.core.sobel")

SHAPES = ((1, 1), (2, 3), (5, 7), (37, 53))
PADDINGS = ("reflect", "edge", "zero")
OPERATORS = ("sobel5", "sobel3", "scharr3", "prewitt3", "sobel7")

CASES = [
    (op, variant, d)
    for op in OPERATORS
    for variant in RF.get_operator(op).variants
    for d in RF.get_operator(op).directions
]


@functools.lru_cache(maxsize=None)
def _inputs(shape):
    """(gray u8, fractional gray f32, RGB u8) frames from a seed."""
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    u8 = rng.integers(0, 256, shape).astype(np.uint8)
    frac = np.clip(rng.uniform(0, 255, shape) + rng.normal(0, 2, shape), 0, 255)
    rgb = rng.integers(0, 256, shape + (3,)).astype(np.uint8)
    return u8, frac.astype(np.float32), rgb


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_rgb_to_gray_matches_reference(shape):
    _u8, _frac, rgb = _inputs(shape)
    np.testing.assert_array_equal(
        rgb_to_gray(torch.from_numpy(rgb)).numpy(), np.asarray(ref_rgb_to_gray(rgb))
    )


@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("op,variant,directions", CASES,
                         ids=[f"{o}-{v}-{d}" for o, v, d in CASES])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sobel_matches_reference(shape, op, variant, directions, padding):
    u8, frac, rgb = _inputs(shape)
    gray = rgb_to_gray(torch.from_numpy(rgb))
    # The reference casts to f32 first; one batch of three runs all inputs.
    ref_in = np.stack([u8.astype(np.float32), frac, gray.numpy()])
    kw = dict(operator=op, variant=variant, directions=directions, padding=padding)
    g_ref, c_ref = RS.sobel(ref_in, return_components=True, **kw)
    g_ref = np.asarray(g_ref)
    c_ref = [np.asarray(c) for c in c_ref]
    for k, x in enumerate((torch.from_numpy(u8), torch.from_numpy(frac), gray)):
        comps = TS.sobel_components(x, **kw)
        assert len(comps) == len(c_ref)
        for c, cr in zip(comps, c_ref):
            assert c.dtype == torch.float32
            np.testing.assert_array_equal(c.numpy(), cr[k])
        np.testing.assert_array_equal(TS.sobel(x, **kw).numpy(), g_ref[k])


def test_valid_padding_and_size_selector_match_reference():
    _u8, frac, _rgb = _inputs((37, 53))
    for size in (3, 5, 7):
        ref = np.asarray(RS.sobel(frac, size=size, padding="valid"))
        got = TS.sobel(torch.from_numpy(frac), size=size, padding="valid").numpy()
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)

