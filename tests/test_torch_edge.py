"""K1's plain version against the reference, and the CUDA wrapper's contract.

``edge_plain`` must give the reference's components and magnitude at any
tile shape, and per-tile maxima equal to a numpy masked max over the same
tiles, so the per-image peak does not depend on the tile shape. The CUDA
kernel itself cannot run on a host without a card: ``edge_cuda`` raises on
a CPU tensor here, and the kernel-against-plain tests are in
``test_torch_gpu.py``.
"""
import importlib

import numpy as np
import pytest
import torch

from repro.core.pipeline import rgb_to_gray as ref_rgb_to_gray
from repro_torch.core.filters import get_operator
from repro_torch.kernels import edge as ekern

RS = importlib.import_module("repro.core.sobel")

BLOCKS = ((8, 8), (5, 7), (16, 32), (64, 256))
OPERATORS = (("sobel5", "v2", 4), ("sobel3", "direct", 2), ("sobel7", "separable", 2))


def _frames(kind, shape=(2, 37, 53)):
    rng = np.random.default_rng(7)
    if kind == "u8":
        return rng.integers(0, 256, shape).astype(np.uint8)
    if kind in ("f32", "rgb_f32"):
        shape = shape + ((3,) if kind == "rgb_f32" else ())
        noisy = rng.uniform(0, 255, shape) + rng.normal(0, 2, shape)
        return np.clip(noisy, 0, 255).astype(np.float32)
    return rng.integers(0, 256, shape + (3,)).astype(np.uint8)


def _numpy_block_max(mag, bh, bw):
    n, h, w = mag.shape
    gh, gw = -(-h // bh), -(-w // bw)
    out = np.zeros((n, gh, gw), np.float32)
    for k in range(gh):
        for j in range(gw):
            out[:, k, j] = mag[:, k * bh:(k + 1) * bh, j * bw:(j + 1) * bw].max(axis=(1, 2))
    return out


@pytest.mark.parametrize("out_components", (False, True), ids=("mag", "comps"))
@pytest.mark.parametrize("block", BLOCKS, ids=lambda b: f"{b[0]}x{b[1]}")
@pytest.mark.parametrize("op,variant,directions", OPERATORS, ids=lambda v: str(v))
@pytest.mark.parametrize("kind", ("u8", "f32", "rgb", "rgb_f32"))
def test_edge_plain_matches_reference(kind, op, variant, directions, block, out_components):
    x = _frames(kind)
    rgb = kind.startswith("rgb")
    gray = np.asarray(ref_rgb_to_gray(x)) if rgb else x.astype(np.float32)
    g_ref, c_ref = RS.sobel(gray, operator=op, variant=variant, directions=directions,
                            return_components=True)
    g_ref = np.asarray(g_ref)
    spec = get_operator(op)
    primary, bmax = ekern.edge_plain(
        torch.from_numpy(x), spec=spec, variant=variant, directions=directions,
        block_h=block[0], block_w=block[1], rgb=rgb,
        out_components=out_components, with_max=True,
    )
    if out_components:
        assert primary.shape == (2, directions, 37, 53)
        np.testing.assert_array_equal(primary.numpy(), np.stack([np.asarray(c) for c in c_ref], 1))
    else:
        np.testing.assert_array_equal(primary.numpy(), g_ref)
    np.testing.assert_array_equal(bmax.numpy(), _numpy_block_max(g_ref, *block))
    np.testing.assert_array_equal(bmax.amax(dim=(1, 2)).numpy(), g_ref.max(axis=(1, 2)))


@pytest.mark.parametrize("padding", ("reflect", "edge", "zero"))
def test_edge_plain_tiny_images(padding):
    spec = get_operator("sobel5")
    for shape in ((1, 1), (2, 3), (5, 7)):
        x = _frames("f32", (1,) + shape)
        g_ref = np.asarray(RS.sobel(x, padding=padding))
        mag, bmax = ekern.edge_plain(torch.from_numpy(x), spec=spec, variant="v2",
                                     directions=4, padding=padding, block_h=4,
                                     block_w=4, with_max=True)
        np.testing.assert_array_equal(mag.numpy(), g_ref)
        np.testing.assert_array_equal(bmax.numpy(), _numpy_block_max(g_ref, 4, 4))


def test_edge_cuda_raises_on_a_cpu_tensor():
    x = torch.zeros((1, 8, 8), dtype=torch.float32)
    before = ekern.edge_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        ekern.edge_cuda(x, spec=get_operator("sobel5"), variant="v2", directions=4)
    assert ekern.edge_cuda.launches == before


def test_kernel_dtype_policy():
    assert ekern.kernel_dtype(torch.zeros(2, dtype=torch.uint8)).dtype == torch.uint8
    for dt in (torch.float64, torch.int32, torch.bool, torch.float16):
        assert ekern.kernel_dtype(torch.zeros(2, dtype=dt)).dtype == torch.float32


@pytest.mark.parametrize("h,w,size", ((2048, 2048, 5), (1, 1, 5), (37, 53, 3), (2048, 2048, 9)))
def test_default_block_shape_fits_shared_memory(h, w, size):
    bh, bw = ekern.default_block_shape(h, w, size)
    assert 1 <= bh <= 32 and 1 <= bw <= 128
    assert bw % 32 == 0
    assert ekern.window_smem_bytes(bh, bw, size // 2) <= ekern.SMEM_DEFAULT


def test_taps_pack_the_sym_rowpass_plan():
    spec = get_operator("sobel5")
    vecs, pass_of, neg = ekern._sym_plan(spec.kd_plus_dense())
    # K_d+ rows are [k0, k1, 0, -k1, -k0] (Eq. 14): two passes, two negated reuses.
    assert len(vecs) == 2 and pass_of == [0, 1, -1, 1, 0] and neg == [0, 0, 0, 1, 1]
    vecs, pass_of, neg = ekern._sym_plan(spec.kd_minus_dense())
    # K_d- rows are [r0, r1, r2, r1, r0]: three passes, plain reuse.
    assert len(vecs) == 3 and pass_of == [0, 1, 2, 1, 0] and neg == [0] * 5
    assert ekern._pack_taps(spec).size == ekern._taps_len()


@pytest.mark.parametrize("padding", ("reflect", "edge", "zero"))
def test_boundary_index_matches_reference(padding):
    import jax.numpy as jnp

    from repro.kernels import tiling as RT
    from repro_torch.kernels import tiling as TT

    for n in (1, 2, 3, 7):
        g = np.arange(-3 * n - 4, 4 * n + 5)
        ref = np.asarray(RT.boundary_index(jnp.asarray(g), n, padding))
        got = TT.boundary_index(torch.from_numpy(g), n, padding).numpy()
        np.testing.assert_array_equal(got, ref)
    assert TT.window_radius(2) == RT.window_radius(2) and TT.window_radius(2, True) == 3
    for k, j in ((0, 0), (1, 2)):
        np.testing.assert_array_equal(TT.valid_mask(k, j, 13, 21, 8, 8).numpy(),
                                      np.asarray(RT.valid_mask(k, j, 13, 21, 8, 8)))
    assert TT.LUMA_WEIGHTS == RT.LUMA_WEIGHTS
