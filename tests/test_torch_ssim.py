"""``repro_torch.core.ssim`` and ``repro_torch.kernels.ref`` against the
reference's ``repro.core.ssim`` and ``repro.kernels.ref`` (XLA), on inputs
made from a seed with numpy.

SSIM: within ``atol=1e-6, rtol=0`` of the reference (both sum in f32 in
their own order; SSIM lies in [-1, 1]). The dense oracle: bit-equal.
"""
import numpy as np
import pytest
import torch

from repro.core.ssim import ssim as ref_ssim
from repro.kernels import ref as jref
from repro_torch.api import EdgeConfig, edge_detect
from repro_torch.core.ssim import ssim
from repro_torch.kernels import ref as tref


def _pair(seed, shape, noise):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, shape).astype(np.float32)
    y = (x + rng.normal(0, noise, shape)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("data_range", (None, 255.0), ids=("range-auto", "range-255"))
@pytest.mark.parametrize("shape", ((32, 32), (2, 40, 53), (2, 3, 17, 29)),
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("noise", (2.0, 40.0))
def test_ssim_matches_reference(shape, data_range, noise):
    x, y = _pair(int(10 * sum(shape) + noise), shape, noise)
    got = ssim(torch.from_numpy(x), torch.from_numpy(y), data_range=data_range)
    want = np.asarray(ref_ssim(x, y, data_range=data_range))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_ssim_identity():
    x = np.random.default_rng(0).integers(0, 256, (2, 32, 32)).astype(np.float32)
    np.testing.assert_allclose(ssim(torch.from_numpy(x), torch.from_numpy(x)).numpy(), 1.0,
                               atol=1e-6)


def test_ssim_degrades_with_noise():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, (32, 32)).astype(np.float32)
    small = x + rng.normal(0, 5, (32, 32)).astype(np.float32)
    big = x + rng.normal(0, 50, (32, 32)).astype(np.float32)
    t = torch.from_numpy
    s_small = float(ssim(t(x), t(small), data_range=255.0))
    s_big = float(ssim(t(x), t(big), data_range=255.0))
    assert 1.0 > s_small > s_big


def test_ssim_symmetry():
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.integers(0, 256, (32, 32)).astype(np.float32))
    b = torch.from_numpy(rng.integers(0, 256, (32, 32)).astype(np.float32))
    assert abs(float(ssim(a, b, data_range=255.0)) - float(ssim(b, a, data_range=255.0))) < 1e-6


def test_paper_fig7_check():
    """The optimized variants against the dense oracle: SSIM == 1 (paper: 0.99)."""
    img = np.random.default_rng(3).integers(0, 256, (2, 64, 64)).astype(np.float32)
    ref = tref.sobel_ref(torch.from_numpy(img))
    for v in ("separable", "v1", "v2"):
        out = edge_detect(img, EdgeConfig(variant=v, normalize=False), device="cpu").magnitude
        assert float(ssim(out, ref).mean()) > 0.999999


@pytest.mark.parametrize("padding", ("reflect", "edge", "zero"))
@pytest.mark.parametrize("size,directions", ((3, 2), (3, 4), (5, 2), (5, 4), (7, 2)))
@pytest.mark.parametrize("shape", ((1, 1), (5, 7), (37, 53)), ids=lambda s: f"{s[0]}x{s[1]}")
def test_dense_oracle_bit_equal_to_reference(shape, size, directions, padding):
    img = np.random.default_rng(sum(shape) + size).uniform(0, 255, (2,) + shape)
    img = img.astype(np.float32)
    kw = dict(size=size, directions=directions, padding=padding)
    got = tref.sobel_components_ref(torch.from_numpy(img), **kw)
    want = jref.sobel_components_ref(img, **kw)
    assert len(got) == len(want) == directions
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    np.testing.assert_array_equal(tref.sobel_ref(torch.from_numpy(img), **kw).numpy(),
                                  np.asarray(jref.sobel_ref(img, **kw)))
