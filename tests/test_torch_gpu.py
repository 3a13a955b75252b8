"""K1 on the card: the CUDA kernel against its plain PyTorch version.

These tests need a CUDA device and ``nvcc`` (the kernel is built from
``src/repro_torch/kernels/csrc`` at first use); without a card they skip.
They import neither ``jax`` nor ``repro``, so they run on a GPU host that
has only the port's dependencies:
``python -m pytest -q -m gpu tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import EdgeConfig, edge_detect
from repro_torch.core.filters import get_operator, make_separable_spec, register_operator
from repro_torch.kernels import edge as ekern

pytestmark = pytest.mark.gpu

# A 9x9 operator (OpenCV's getDerivKernels(1, 0, ksize=9)): the largest size
# csrc/edge.cu instantiates.
register_operator("sep9", make_separable_spec(
    "sep9", (1.0, 8.0, 28.0, 56.0, 70.0, 56.0, 28.0, 8.0, 1.0),
    (-1.0, -6.0, -14.0, -14.0, 0.0, 14.0, 14.0, 6.0, 1.0)), overwrite=True)
assert get_operator("sep9").size == ekern.KMAX

OPERATORS = ("sobel5", "sobel3", "scharr3", "prewitt3", "sobel7", "sep9")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


def _frames(kind, shape, device):
    rng = np.random.default_rng(11)
    if kind == "u8":
        a = rng.integers(0, 256, shape).astype(np.uint8)
    elif kind in ("f32", "rgb_f32"):
        shape = shape + ((3,) if kind == "rgb_f32" else ())
        a = np.clip(rng.uniform(0, 255, shape) + rng.normal(0, 2, shape), 0, 255)
        a = a.astype(np.float32)
    else:
        a = rng.integers(0, 256, shape + (3,)).astype(np.uint8)
    return torch.from_numpy(a).to(device)


@pytest.mark.parametrize("shape", ((1, 1), (2, 3), (5, 7), (237, 413)),
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ("u8", "f32", "rgb", "rgb_f32"))
def test_edge_cuda_equals_plain(cuda_device, kind, shape):
    x = _frames(kind, (2,) + shape, cuda_device)
    for op in OPERATORS:
        spec = get_operator(op)
        for variant in spec.variants:
            for d in spec.directions:
                for padding in ("reflect", "edge", "zero"):
                    for out_components in (False, True):
                        kw = dict(spec=spec, variant=variant, directions=d, padding=padding,
                                  block_h=16, block_w=32, rgb=kind.startswith("rgb"),
                                  out_components=out_components, with_max=True)
                        a, am = ekern.edge_cuda(x, **kw)
                        b, bm = ekern.edge_plain(x, **kw)
                        assert torch.equal(a, b) and torch.equal(am, bm), (op, variant, d, padding)


def test_edge_cuda_counts_its_launches(cuda_device):
    x = _frames("f32", (1, 40, 50), cuda_device)
    before = ekern.edge_cuda.launches
    ekern.edge_cuda(x, spec=get_operator("sobel5"), variant="v2", directions=4)
    assert ekern.edge_cuda.launches == before + 1
    ekern.edge_plain(x, spec=get_operator("sobel5"), variant="v2", directions=4)
    assert ekern.edge_cuda.launches == before + 1


def test_edge_cuda_rejects_what_it_does_not_take(cuda_device):
    spec = get_operator("sobel5")
    kw = dict(spec=spec, variant="v2", directions=4)
    with pytest.raises(TypeError):
        ekern.edge_cuda(torch.zeros((1, 8, 8), dtype=torch.float64, device=cuda_device), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        ekern.edge_cuda(torch.zeros((1, 8, 16), device=cuda_device)[:, :, ::2], **kw)
    with pytest.raises(ValueError, match="shared memory"):
        ekern.edge_cuda(torch.zeros((1, 8, 8), device=cuda_device), block_h=256,
                        block_w=256, **kw)
    with pytest.raises(ValueError, match="unresolved"):
        ekern.edge_cuda(torch.zeros((1, 8, 8), device=cuda_device), spec=spec,
                        variant="auto", directions=4)


@pytest.mark.parametrize("config", (
    {}, dict(normalize=False, with_max=True),
    dict(with_components=True, with_orientation=True, with_max=True),
    dict(operator="scharr3", padding="zero"),
), ids=str)
def test_facade_cuda_lane_equals_torch_lane(cuda_device, config):
    for kind, shape in (("rgb", (2, 3, 45, 67)), ("rgb_f32", (2, 45, 67)), ("u8", (3, 45, 67)),
                        ("f32", (45, 67))):
        x = _frames(kind, shape, cuda_device)
        before = ekern.edge_cuda.launches
        res = edge_detect(x, EdgeConfig(**config))
        assert ekern.edge_cuda.launches == before + 1
        ref = edge_detect(x, EdgeConfig(backend="torch", **config))
        for field in ("magnitude", "components", "orientation", "peak"):
            a, b = getattr(res, field), getattr(ref, field)
            assert (a is None) == (b is None), field
            if a is not None:
                assert a.device.type == "cuda" and torch.equal(a, b), field
