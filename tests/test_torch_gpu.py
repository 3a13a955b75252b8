"""K1-K5 on the card: the CUDA kernels against their plain PyTorch versions,
and the LM engine's K4 and K5 lanes (and the hybrid, encdec and vlm
models' K4 lane) against the plain lane.

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


NMS_OPERATORS = ("sobel5", "sobel3", "scharr3", "sobel7", "sep9")


@pytest.mark.parametrize("shape", ((1, 1), (2, 3), (37, 53), (70, 270)),
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ("u8", "f32", "rgb", "rgb_f32"))
def test_edge_cuda_nms_equals_plain(cuda_device, kind, shape):
    """K1's NMS outputs: thin map, centre components, un-thinned magnitude
    and per-tile max, for every size, direction count and padding."""
    x = _frames(kind, (2,) + shape, cuda_device)
    for op in NMS_OPERATORS:
        spec = get_operator(op)
        variant = spec.resolve_variant("auto")
        for d in spec.directions:
            for padding in ("reflect", "edge", "zero"):
                for block in ((16, 32), (64, 256)):
                    for extras in (dict(), dict(out_components=True, out_mag=True,
                                                with_max=True), dict(with_max=True)):
                        kw = dict(spec=spec, variant=variant, directions=d, padding=padding,
                                  block_h=block[0], block_w=block[1],
                                  rgb=kind.startswith("rgb"), out_nms=True, **extras)
                        a = ekern.edge_cuda(x, **kw)
                        b = ekern.edge_plain(x, **kw)
                        a = a if isinstance(a, tuple) else (a,)
                        b = b if isinstance(b, tuple) else (b,)
                        assert len(a) == len(b)
                        for u, v in zip(a, b):
                            assert torch.equal(u, v), (op, d, padding, block, extras)


def _masks(n, gh, gw, device):
    rng = np.random.default_rng(3)
    return {
        "none": torch.zeros((n, gh, gw), dtype=torch.int32, device=device),
        "all": torch.ones((n, gh, gw), dtype=torch.int32, device=device),
        "random": torch.from_numpy(rng.integers(0, 2, (n, gh, gw)).astype(np.int32)).to(device),
    }


@pytest.mark.parametrize("shape", ((1, 1), (37, 53), (130, 300)), ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ("u8", "f32", "rgb"))
@pytest.mark.parametrize("out_nms", (False, True), ids=("mag", "nms"))
def test_edge_stream_cuda_equals_plain(cuda_device, out_nms, kind, shape):
    x = _frames(kind, (2,) + shape, cuda_device)
    spec = get_operator("sobel5")
    bh, bw = 16, 64
    gh, gw = -(-shape[0] // bh), -(-shape[1] // bw)
    prev = torch.from_numpy(np.random.default_rng(1).uniform(0, 9, (2,) + shape)
                            .astype(np.float32)).to(cuda_device)
    prev_max = torch.full((2, gh, gw), 7.0, device=cuda_device)
    kw = dict(spec=spec, variant="v2", directions=4, block_h=bh, block_w=bw,
              rgb=kind == "rgb", out_nms=out_nms)
    for name, mask in _masks(2, gh, gw, cuda_device).items():
        before = ekern.edge_stream_cuda.launches
        a = ekern.edge_stream_cuda(x, prev, prev_max, mask, **kw)
        assert ekern.edge_stream_cuda.launches == before + 1
        b = ekern.edge_stream_plain(x, prev, prev_max, mask, **kw)
        assert ekern.edge_stream_cuda.launches == before + 1
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), name
        if name == "all":   # every tile recomputed: K3 equals K1
            k1 = ekern.edge_cuda(x, spec=spec, variant="v2", directions=4, block_h=bh,
                                 block_w=bw, rgb=kind == "rgb", out_nms=out_nms,
                                 with_max=True)
            assert torch.equal(a[0], k1[0]) and torch.equal(a[1], k1[1])
        if name == "none":
            assert torch.equal(a[0], prev) and torch.equal(a[1], prev_max)


def test_edge_stream_cuda_rejects_what_it_does_not_take(cuda_device):
    spec = get_operator("sobel5")
    x = torch.zeros((1, 16, 16), dtype=torch.uint8, device=cuda_device)
    prev = torch.zeros((1, 16, 16), device=cuda_device)
    bmax = torch.zeros((1, 2, 2), device=cuda_device)
    mask = torch.ones((1, 2, 2), dtype=torch.int32, device=cuda_device)
    kw = dict(spec=spec, variant="v2", directions=4, block_h=8, block_w=8)
    with pytest.raises(ValueError, match="int32"):
        ekern.edge_stream_cuda(x, prev, bmax, mask.to(torch.int64), **kw)
    with pytest.raises(ValueError, match="tile grid"):
        ekern.edge_stream_cuda(x, prev, bmax[:, :1], mask, **kw)
    with pytest.raises(ValueError, match="float32"):
        ekern.edge_stream_cuda(x, prev.cpu(), bmax, mask, **kw)
    with pytest.raises(ValueError, match="out_mag"):
        ekern.edge_cuda(x, out_mag=True, **kw)
    with pytest.raises(ValueError, match="shared memory"):
        ekern.edge_cuda(x, **dict(kw, block_h=200, block_w=200), out_nms=True)


def test_nms_facade_and_stream_cuda_lane_equal_torch_lane(cuda_device):
    from repro_torch.api import edge_detect_stream

    x = _frames("u8", (2, 45, 67), cuda_device)
    cfg = EdgeConfig(hysteresis=True, with_max=True)
    res = edge_detect(x, cfg)
    ref = edge_detect(x, cfg.replace(backend="torch"))
    for field in ("magnitude", "thin", "edges", "peak"):
        assert torch.equal(getattr(res, field), getattr(ref, field)), field
    cfg = EdgeConfig(temporal=True, decay=0.9, block_h=16, block_w=32)
    state = ref_state = None
    before = ekern.edge_stream_cuda.launches
    for t in range(4):
        f = x.clone()
        f[:, 10 + 3 * t:20 + 3 * t, 5:15] = 255
        out, state = edge_detect_stream(f, cfg, state)
        want, ref_state = edge_detect_stream(f, cfg.replace(backend="torch"), ref_state)
        assert torch.equal(out.edges, want.edges) and torch.equal(out.skipped, want.skipped)
        assert torch.equal(state.seed, ref_state.seed)
    assert ekern.edge_stream_cuda.launches == before + 4


def test_stream_engine_raises_when_k3_keeps_failing(cuda_device, monkeypatch):
    """On the card a K3 that fails past the retries raises out of the
    engine; nothing serves the step through the plain lane instead."""
    from repro_torch.runtime.fault import FaultPolicy
    from repro_torch.serve import StreamEngine, StreamRequest
    from repro_torch.serve.guard import GuardPolicy

    def refused(*a, **k):
        raise RuntimeError("K3 launch refused")

    monkeypatch.setattr(ekern, "edge_stream_cuda", refused)
    policy = GuardPolicy(fault=FaultPolicy(max_retries_per_step=2, backoff_s=0.0))
    eng = StreamEngine(EdgeConfig(hysteresis=True, block_h=16, block_w=32), max_streams=1,
                       guard=policy)
    frame = np.random.default_rng(3).integers(0, 256, (45, 67)).astype(np.uint8)
    eng.submit(StreamRequest(sid=0, frames=[frame, frame]))
    with pytest.raises(RuntimeError, match="K3 launch refused"):
        eng.run()
    assert eng.health.backend == "cuda" and not eng.health.degraded
    assert eng.health.counts["degraded"] == 0


K2_EXTRAS = (dict(with_max=True), dict(out_components=True, with_max=True),
             dict(out_nms=True), dict(out_nms=True, out_components=True, out_mag=True,
                                      with_max=True))


def _same(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("shape", ((1, 1), (2, 3), (37, 53), (70, 270)),
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ("u8", "f32", "rgb", "rgb_f32"))
@pytest.mark.parametrize("depth", (2, 3, 8))
def test_edge_pipelined_cuda_equals_plain(cuda_device, depth, kind, shape):
    """K2 at ring depths 2, 3 and 8 (the 70x270 grid has gw < depth at
    depth 8 with 64-wide tiles), with and without NMS, equals edge_plain
    and K1 bit for bit, and counts its launches apart from K1's."""
    x = _frames(kind, (2,) + shape, cuda_device)
    for op in ("sobel5", "sobel3", "sobel7", "sep9"):
        spec = get_operator(op)
        for variant in spec.variants:
            for d in spec.directions:
                for padding in ("reflect", "zero"):
                    for extra in K2_EXTRAS:
                        kw = dict(spec=spec, variant=variant, directions=d, padding=padding,
                                  block_h=16, block_w=64, rgb=kind.startswith("rgb"), **extra)
                        k1, k2 = ekern.edge_cuda.launches, ekern.edge_pipelined_cuda.launches
                        a = ekern.edge_cuda(x, pipeline_depth=depth, **kw)
                        assert ekern.edge_pipelined_cuda.launches == k2 + 1
                        assert ekern.edge_cuda.launches == k1
                        assert _same(a, ekern.edge_plain(x, **kw)), (op, variant, d, padding)
                        assert _same(a, ekern.edge_cuda(x, **kw)), (op, variant, d, padding)


@pytest.mark.parametrize("shape", ((1, 1), (2, 3), (37, 53), (237, 413)),
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("depth", (0, 2))
def test_int_lane_equals_f32_lane(cuda_device, depth, shape):
    """K1 (depth 0) and K2 on the integer lane equal the f32 lane for every
    int-eligible operator, variant, direction count and padding."""
    x = _frames("u8", (2,) + shape, cuda_device)
    for op in ("prewitt3", "scharr3", "sobel3", "sobel5", "sobel7"):
        spec = get_operator(op)
        for variant in spec.variants:
            for d in spec.directions:
                for padding in ("reflect", "edge", "zero"):
                    for extra in K2_EXTRAS:
                        kw = dict(spec=spec, variant=variant, directions=d, padding=padding,
                                  block_h=32, block_w=64, pipeline_depth=depth, **extra)
                        counter = ekern.edge_pipelined_cuda if depth else ekern.edge_cuda
                        before = counter.int_launches
                        a = ekern.edge_cuda(x, precision="int", **kw)
                        assert counter.int_launches == before + 1
                        assert _same(a, ekern.edge_plain(x, **kw)), (op, variant, d, padding)


def test_facade_auto_precision_runs_the_int_lane(cuda_device):
    x = _frames("u8", (3, 45, 67), cuda_device)
    before = ekern.edge_cuda.int_launches
    res = edge_detect(x, EdgeConfig(with_max=True))
    assert ekern.edge_cuda.int_launches == before + 1
    ref = edge_detect(x, EdgeConfig(with_max=True, backend="torch"))
    assert torch.equal(res.magnitude, ref.magnitude) and torch.equal(res.peak, ref.peak)
    before = ekern.edge_cuda.int_launches
    edge_detect(_frames("f32", (3, 45, 67), cuda_device))
    edge_detect(x, EdgeConfig(precision="f32"))
    assert ekern.edge_cuda.int_launches == before
    before = ekern.edge_pipelined_cuda.int_launches
    res = edge_detect(x, EdgeConfig(pipeline_depth=3, nms=True))
    assert ekern.edge_pipelined_cuda.int_launches == before + 1
    assert torch.equal(res.magnitude, edge_detect(x, EdgeConfig(nms=True, backend="torch")).magnitude)


def test_depth_over_the_shared_memory_budget_raises(cuda_device):
    spec = get_operator("sobel5")
    x = torch.zeros((1, 256, 256), device=cuda_device)
    k1, k2 = ekern.edge_cuda.launches, ekern.edge_pipelined_cuda.launches
    with pytest.raises(ValueError, match=r"pipeline_depth=3 with tile 64x256 needs 288128 B"):
        ekern.edge_cuda(x, spec=spec, variant="v2", directions=4, block_h=64, block_w=256,
                        pipeline_depth=3)
    with pytest.raises(ValueError, match="shared memory"):
        edge_detect(x, EdgeConfig(block_h=64, block_w=256, pipeline_depth=8))
    assert (ekern.edge_cuda.launches, ekern.edge_pipelined_cuda.launches) == (k1, k2)


def test_failing_k2_launch_raises_without_fallback(cuda_device, monkeypatch):
    """A K2 launch the device refuses raises; nothing serves the call
    through K1, a lower depth or the plain version instead."""
    real = ekern._lib("edge_pipelined")

    class Refusing:
        def __getattr__(self, name):
            return getattr(real, name)

        def repro_pipelined_launch(self, *args):
            return 1  # cudaErrorInvalidValue

    monkeypatch.setattr(ekern, "_lib", lambda name: Refusing() if name == "edge_pipelined"
                        else real)
    plain = ekern.edge_plain
    monkeypatch.setattr(ekern, "edge_plain", lambda *a, **k: pytest.fail("fell back to plain"))
    x = _frames("u8", (2, 45, 67), cuda_device)
    k1, k2 = ekern.edge_cuda.launches, ekern.edge_pipelined_cuda.launches
    with pytest.raises(RuntimeError, match="edge_pipelined kernel launch failed"):
        edge_detect(x, EdgeConfig(pipeline_depth=2))
    with pytest.raises(RuntimeError, match="edge_pipelined kernel launch failed"):
        ekern.edge_cuda(x, spec=get_operator("sobel5"), variant="v2", directions=4,
                        pipeline_depth=4)
    assert (ekern.edge_cuda.launches, ekern.edge_pipelined_cuda.launches) == (k1, k2)
    assert plain is not ekern.edge_plain


def test_k2_footprint_matches_the_source(cuda_device):
    """edge.pipelined_smem_bytes, which the wrapper and the tuner size K2
    by, equals pipelined_layout in csrc/edge_pipelined.cu, and
    edge.pipelined_bands the source's band count."""
    lib = ekern._lib("edge_pipelined")
    for bh, bw in ((1, 1), (8, 32), (32, 64), (29, 96), (64, 256), (128, 128), (300, 512)):
        for radius in (1, 2, 3, 4):
            for nms in (False, True):
                assert lib.repro_pipelined_bands(bh, bw, int(nms), 2 * radius + 1) == len(
                    ekern.pipelined_bands(bh, bw, nms, 2 * radius + 1)), (bh, bw, radius, nms)
                for depth in ekern.PIPELINE_DEPTHS:
                    for in_bytes, channels in ((1, 1), (4, 1), (1, 3), (4, 3)):
                        want = ekern.pipelined_smem_bytes(bh, bw, radius, depth, in_bytes,
                                                          channels, nms)
                        got = lib.repro_pipelined_smem_bytes(bh, bw, radius, depth, in_bytes,
                                                             channels, int(nms))
                        assert got == want, (bh, bw, radius, depth, in_bytes, channels, nms)


def _offset(x):
    """A contiguous copy of x whose base is one element past 16 bytes: K2
    takes the cp.async route whatever the row pitch."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = flat[1:].view(x.shape)
    y.copy_(x)
    return y


@pytest.mark.parametrize("shape", ((1, 2, 3), (2, 37, 53), (2, 29, 96), (3, 70, 260),
                                   (5, 300, 640)),
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", ("u8", "f32", "rgb", "int"))
@pytest.mark.parametrize("depth", tuple(ekern.PIPELINE_DEPTHS))
def test_k2_depths_routes_and_instances_equal_k1(cuda_device, depth, kind, shape):
    """K2 at every ring depth, on f32, u8 and RGB frames and the integer
    lane, NMS off and on, both instances and both copy routes (gray rows of
    16 bytes take TMA, the rest and an offset copy cp.async), on batches with
    fewer tiles than the persistent grid has CTAs (1x2x3) and with more
    (5x300x640 on 16x64 tiles: 950), equals K1 and edge_plain bit for bit."""
    x = _frames("u8" if kind == "int" else kind, shape, cuda_device)
    rgb, w = kind == "rgb", shape[2]
    spec = get_operator("sobel5")
    tma0, cp0 = ekern.edge_pipelined_cuda.tma_launches, ekern.edge_pipelined_cuda.cp_async_launches
    for xx in (x, _offset(x)):
        for extra in K2_EXTRAS[:1] + K2_EXTRAS[-1:]:
            for instance in ("auto", "runtime"):
                kw = dict(spec=spec, variant="v2", directions=4, block_h=16, block_w=64,
                          rgb=rgb, precision="int" if kind == "int" else "f32", **extra)
                a = ekern.edge_cuda(xx, pipeline_depth=depth, instance=instance, **kw)
                assert _same(a, ekern.edge_plain(xx, **kw)), (extra, instance)
                assert _same(a, ekern.edge_cuda(xx, instance=instance, **kw)), (extra, instance)
    aligned = not rgb and (w * x.element_size()) % 16 == 0   # TMA: gray, 16-byte rows
    tma = ekern.edge_pipelined_cuda.tma_launches - tma0
    cp = ekern.edge_pipelined_cuda.cp_async_launches - cp0
    assert (tma, cp) == ((4, 4) if aligned else (0, 8))


def test_tuned_tile_too_big_for_nms_serves_every_call(cuda_device, tmp_path, monkeypatch):
    """A cache entry that fits the magnitude lane only (128x256 needs
    307,360 B with NMS) steers the magnitude lane and is skipped, with a
    warning, by an NMS call and a stream step, which then run and equal
    the torch lane."""
    from repro_torch.api import edge_detect_stream
    from repro_torch.kernels import tuning

    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "c.json"))
    cache = tuning.TuningCache()
    cache.record(tuning.TuneKey("cuda", "float32", "sobel5", "v2", 256, 512), 128, 256, 1.0)
    cache.save()
    x = _frames("f32", (2, 256, 512), cuda_device)
    res = edge_detect(x, EdgeConfig(with_max=True))
    assert res.peak is not None
    with pytest.warns(RuntimeWarning, match="skipping tuned tile 128x256"):
        res = edge_detect(x, EdgeConfig(nms=True, hysteresis=True, with_max=True))
    ref = edge_detect(x, EdgeConfig(nms=True, hysteresis=True, with_max=True, backend="torch"))
    for field in ("magnitude", "edges", "peak"):
        assert torch.equal(getattr(res, field), getattr(ref, field)), field
    cfg = EdgeConfig(nms=True, hysteresis=True)
    with pytest.warns(RuntimeWarning, match="skipping tuned tile 128x256"):
        out, state = edge_detect_stream(x, cfg)
    want, _ = edge_detect_stream(x, cfg.replace(backend="torch"))
    assert state.block == ekern.default_block_shape(256, 512, 5)
    assert torch.equal(out.edges, want.edges)


# ---------------------------------------------------------------------------
# K4 (flash attention) and the LM path
# ---------------------------------------------------------------------------

def _qkv(shape, dtype, device, seed=12):
    b, h, s, t, d = shape
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(n, generator=g).to(dtype=dtype, device=device)
                 for n in ((b, h, s, d), (b, h, t, d), (b, h, t, d)))


@pytest.mark.parametrize("shape", [(2, 3, 16, 16, 8), (2, 2, 8, 24, 8), (1, 4, 65, 65, 64),
                                   (1, 2, 129, 129, 128), (1, 32, 200, 200, 64),
                                   (2, 2, 7, 7, 4)], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_cuda_equals_plain(cuda_device, shape, dtype, causal):
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    q, k, v = _qkv(shape, dtype, cuda_device)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, block_q=shape[2], block_kv=shape[3])
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1 and got.dtype == dtype
    want = flash_attention_plain(q, k, v, causal=causal)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:   # both round an f32 result once: one bf16 ulp of the output, plus
        # the f32 tolerance where the output's ulp is below it (near 0)
        w = want.float()
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
        assert bool(((got.float() - w).abs() <= ulp + 2e-5).all())


def test_flash_attention_cuda_rejects_what_it_does_not_take(cuda_device):
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = _qkv((1, 2, 8, 8, 8), torch.float32, cuda_device)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        flash_attention(q, k.bfloat16(), v)
    big = torch.zeros(1, 1, 8, 160, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(big, big, big)
    with pytest.raises(ValueError, match="must divide"):
        flash_attention(q, k, v, block_q=3)


def test_lm_engine_k4_lane_equals_plain_lane(cuda_device):
    """The smoke llama through the Engine on the card, K4 lane and plain
    lane, on the same weights: the same tokens, K4 launched once per layer
    per prefill, and prefill logits within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import Model
    from repro_torch.serve import Engine, Request

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama3.2-1b", smoke=True).replace(dtype="float32")
    params = Model(cfg).init(0)
    prompts = [[5, 9, 2, 7], [11, 3], list(range(1, 13)), [42], [13, 14, 15], list(range(30))]
    outs, launches = {}, {}
    for backend in ("auto", "torch"):
        eng = Engine(cfg, params, max_batch=3, max_len=64, prompt_buckets=(8, 16, 32),
                     backend=backend)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=6))
        before = flash_attention.launches
        outs[backend] = {r.uid: r.output for r in eng.run()}
        launches[backend] = flash_attention.launches - before
    assert launches == {"auto": cfg.num_layers * 5, "torch": 0}   # [42] has no context
    assert outs["auto"] == outs["torch"]
    tokens = torch.tensor([list(range(1, 30))], device=cuda_device)
    logits = {b: Model(cfg, backend=b).prefill(
        params, {"tokens": tokens}, Model(cfg).init_cache(1, 32, dtype=torch.float32))[0]
        for b in ("auto", "torch")}
    torch.testing.assert_close(logits["auto"], logits["torch"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ("qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b", "minicpm3-4b"))
def test_moe_and_mla_engine_k4_lane_equals_plain_lane(cuda_device, arch):
    """The smoke MoE and MLA models through the Engine on the card, K4 lane
    and plain lane, on the same weights: K4 launched once per layer per
    prefill (MLA with v zero-padded to k's width), the same tokens wherever
    both lanes routed every token to the same experts, and prefill logits
    within 1e-4 under the same condition."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import Model
    from repro_torch.models.moe import record_routing
    from repro_torch.serve import Engine, Request

    def same_routes(a, b):
        return len(a) == len(b) and all(torch.equal(ia.sort(-1).values, ib.sort(-1).values)
                                        for (_, ia, _), (_, ib, _) in zip(a, b))

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    params = Model(cfg).init(0)
    prompts = [[5, 9, 2, 7], [11, 3], list(range(1, 13)), [42], [13, 14, 15], list(range(30))]
    outs, launches, logs = {}, {}, {}
    for backend in ("auto", "torch"):
        eng = Engine(cfg, params, max_batch=3, max_len=64, prompt_buckets=(8, 16, 32),
                     backend=backend)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=6))
        before = flash_attention.launches
        with record_routing() as logs[backend]:
            outs[backend] = {r.uid: r.output for r in eng.run()}
        launches[backend] = flash_attention.launches - before
    assert launches == {"auto": cfg.num_layers * 5, "torch": 0}   # [42] has no context
    if same_routes(logs["auto"], logs["torch"]):
        assert outs["auto"] == outs["torch"]
    tokens = torch.tensor([list(range(1, 30))], device=cuda_device)
    logits, routes = {}, {}
    for b in ("auto", "torch"):
        with record_routing() as routes[b]:
            logits[b] = Model(cfg, backend=b).prefill(
                params, {"tokens": tokens}, Model(cfg).init_cache(1, 32, dtype=torch.float32))[0]
    if same_routes(routes["auto"], routes["torch"]):
        torch.testing.assert_close(logits["auto"], logits["torch"], rtol=1e-4, atol=1e-4)


def test_lm_prefill_on_card_refuses_index_mismatch(cuda_device):
    """K4 masks by index: a causal prefill whose positions are not
    arange(S) raises on the card instead of taking the plain lane."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = get_config("llama3.2-1b", smoke=True).replace(dtype="float32")
    model = Model(cfg)
    params = model.init(0)
    tokens = torch.zeros(1, 6, dtype=torch.int32, device=cuda_device)
    positions = torch.arange(6, device=cuda_device, dtype=torch.int32)[None] + 2
    with pytest.raises(ValueError, match="arange"):
        model.forward(params, {"tokens": tokens, "positions": positions})
    with pytest.raises(ValueError, match="softcap"):
        Model(cfg.replace(attn_logit_softcap=30.0)).forward(params, {"tokens": tokens})


# ---------------------------------------------------------------------------
# K5 (selective scan) and the ssm path
# ---------------------------------------------------------------------------

K5_TOL = 3e-5     # f32: tests/test_kernels.py::test_selective_scan_kernel


def _scan_inputs(shape, dtype, device, seed=13):
    """The reference test's distributions: x, B, C ~ N(0, 1), dt = |N(0, 0.1)|,
    A = -|N(1, 0.3)|."""
    bsz, l, di, n = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(bsz, l, di, generator=g)
    dt = (torch.randn(bsz, l, di, generator=g) * 0.1).abs()
    bm, cm = torch.randn(bsz, l, n, generator=g), torch.randn(bsz, l, n, generator=g)
    a = -(1 + 0.3 * torch.randn(di, n, generator=g)).abs()
    return [t.to(dtype=dtype, device=device) for t in (x, dt, bm, cm)] + [a.to(device)]


@pytest.mark.parametrize("shape", [(2, 32, 16, 4), (2, 7, 24, 1), (1, 1, 200, 4),
                                   (2, 7, 200, 16), (1, 300, 24, 16), (3, 5, 5, 3),
                                   (1, 33, 40, 32), (1, 64, 8192, 16), (2, 40, 64, 33),
                                   (1, 129, 48, 64)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_selective_scan_cuda_equals_plain(cuda_device, shape, dtype):
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_plain

    args = _scan_inputs(shape, dtype, cuda_device)
    before = selective_scan.launches
    y, h = selective_scan(*args, chunk=shape[1], block_d=shape[2])
    torch.cuda.synchronize()
    assert selective_scan.launches == before + 1
    assert y.dtype == dtype and h.dtype == torch.float32 and h.shape == (shape[0],) + shape[2:]
    wy, wh = selective_scan_plain(*args)
    torch.testing.assert_close(h, wh, rtol=K5_TOL, atol=K5_TOL)
    if dtype == torch.float32:
        torch.testing.assert_close(y, wy, rtol=K5_TOL, atol=K5_TOL)
    else:   # both round an f32 result once: one bf16 ulp, plus the f32 tolerance
        w = wy.float()
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
        assert bool(((y.float() - w).abs() <= ulp + K5_TOL).all())


@pytest.mark.parametrize("l", (1, 31, 33, 64, 100, 2049))
@pytest.mark.parametrize("n", (1, 3, 16, 17, 32))
@pytest.mark.parametrize("bsz", (1, 4))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_selective_scan_cuda_lengths_states_and_batches(cuda_device, l, n, bsz, dtype):
    """K5 with L from 1 to 2,049 (off the 32-step chunks), N from 1 to 32,
    batches of 1 and 4, f32 and bf16: y and the final state against the
    plain version, y bit for bit in f32 (the reduction keeps the plain
    version's order for N <= 32), the copy route counted."""
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_plain

    shape = (bsz, l, 96, n)
    args = _scan_inputs(shape, dtype, cuda_device, seed=l * 37 + n)
    before = selective_scan.async_launches
    y, h = selective_scan(*args, chunk=l, block_d=96)
    torch.cuda.synchronize()
    aligned = (l * n * args[0].element_size()) % 16 == 0   # B and C rows of a batch
    assert selective_scan.async_launches - before == int(aligned)
    wy, wh = selective_scan_plain(*args)
    torch.testing.assert_close(h, wh, rtol=K5_TOL, atol=K5_TOL)
    if dtype == torch.float32:
        torch.testing.assert_close(y, wy, rtol=K5_TOL, atol=K5_TOL)
    else:
        w = wy.float()
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
        assert bool(((y.float() - w).abs() <= ulp + K5_TOL).all())


def test_selective_scan_cuda_rejects_what_it_does_not_take(cuda_device):
    from repro_torch.kernels import selective_scan as k5
    from repro_torch.kernels.selective_scan import selective_scan

    x, dt, bm, cm, a = _scan_inputs((1, 8, 16, 4), torch.float32, cuda_device)
    with pytest.raises(TypeError):
        selective_scan(x.half(), dt.half(), bm.half(), cm.half(), a)
    with pytest.raises(TypeError):
        selective_scan(x, dt.bfloat16(), bm, cm, a)
    big = _scan_inputs((1, 8, 16, k5.NMAX + 1), torch.float32, cuda_device)
    with pytest.raises(ValueError, match="state size"):
        selective_scan(*big)
    with pytest.raises(ValueError, match="must divide"):
        selective_scan(x, dt, bm, cm, a, chunk=3)
    with pytest.raises(ValueError, match="one device"):
        selective_scan(x, dt, bm, cm, a.cpu())


def test_ssm_engine_k5_lane_equals_plain_lane(cuda_device):
    """The smoke falcon-mamba through the Engine on the card, K5 lane and
    plain lane, on the same weights and bucket-length prompts: the same
    tokens, K5 launched once per layer per prefill, and prefill logits and
    caches within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.selective_scan import selective_scan
    from repro_torch.models import Model
    from repro_torch.serve import Engine, Request

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("falcon-mamba-7b", smoke=True).replace(dtype="float32")
    params = Model(cfg).init(0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n + 1).tolist() for n in (8, 16, 0, 32, 8, 16)]
    outs, launches = {}, {}
    for backend in ("auto", "torch"):
        eng = Engine(cfg, params, max_batch=3, max_len=64, prompt_buckets=(8, 16, 32),
                     backend=backend)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=6))
        before = selective_scan.launches
        outs[backend] = {r.uid: r.output for r in eng.run()}
        launches[backend] = selective_scan.launches - before
    assert launches == {"auto": cfg.num_layers * 5, "torch": 0}   # one prompt has no context
    assert outs["auto"] == outs["torch"]
    tokens = torch.tensor([list(range(1, 30))], device=cuda_device)
    got = {}
    for b in ("auto", "torch"):
        cache = Model(cfg).init_cache(1, 32, dtype=torch.float32)
        got[b] = Model(cfg, backend=b).prefill(params, {"tokens": tokens}, cache)
    torch.testing.assert_close(got["auto"][0], got["torch"][0], rtol=1e-4, atol=1e-4)
    for name in ("h", "conv"):
        torch.testing.assert_close(got["auto"][1]["layers"][name],
                                   got["torch"][1]["layers"][name], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The hybrid, encdec and vlm families (zamba2, whisper, pixtral) on K4
# ---------------------------------------------------------------------------

# K4 at the three families' prefill shapes, (B, H, S, T, D) and causal, cut
# in B and S where the FULL run's shapes would only repeat the same tiles:
# zamba2's shared block (D = 80 on the D <= 128 instance), whisper's
# encoder, decoder self- and cross-attention, pixtral's 1,024 patches + text.
NEW_K4_SHAPES = [((1, 32, 2048, 2048, 80), True), ((1, 32, 8, 8, 80), True),
                 ((2, 20, 1500, 1500, 64), False), ((2, 20, 32, 1500, 64), False),
                 ((2, 20, 32, 32, 64), True), ((1, 32, 1056, 1056, 128), True)]


@pytest.mark.parametrize("shape,causal", NEW_K4_SHAPES,
                         ids=lambda a: "x".join(map(str, a)) if isinstance(a, tuple) else
                         ("causal" if a else "full"))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_cuda_at_the_new_families_shapes(cuda_device, shape, causal, dtype):
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    q, k, v = _qkv(shape, dtype, cuda_device)
    got = flash_attention(q, k, v, causal=causal, block_q=shape[2], block_kv=shape[3])
    want = flash_attention_plain(q, k, v, causal=causal)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        w = want.float()
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
        assert bool(((got.float() - w).abs() <= ulp + 2e-5).all())


def _k4_per_prefill(cfg) -> int:
    """K4 launches of one prefill: one a layer (dense, vlm), one a shared
    block application (hybrid), encoder + decoder self + cross (encdec)."""
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.num_layers
    return cfg.num_layers


@pytest.mark.parametrize("arch", ("zamba2-2.7b", "whisper-large-v3", "pixtral-12b"))
def test_new_families_k4_lane_equals_plain_lane(cuda_device, arch):
    """The smoke zamba2, whisper and pixtral on the card, K4 lane and plain
    lane on the same weights: a prefill of 2 prompts (with the frontend
    stubs' inputs, whisper's 3 frames short of encoder_len) launches K4 as
    many times as the family's attention calls, logits within 1e-4, then 4
    greedy decode steps launch nothing and give the same tokens."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    params = Model(cfg).init(0)
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (2, 9), generator=g).to(cuda_device)
    extra = {}
    if cfg.family == "encdec":
        extra["enc_embeds"] = (torch.randn(2, cfg.encoder_len - 3, cfg.d_model, generator=g)
                               * 0.5).to(cuda_device)
    if cfg.family == "vlm":
        extra["patch_embeds"] = (torch.randn(2, cfg.num_patches, cfg.d_model, generator=g)
                                 * 0.5).to(cuda_device)
    off = cfg.num_patches if cfg.family == "vlm" else 0
    logits, toks, launches = {}, {}, {}
    for backend in ("auto", "torch"):
        model = Model(cfg, backend=backend)
        cache = model.init_cache(2, off + 16, dtype=torch.float32)
        before = flash_attention.launches
        logits[backend], cache = model.prefill(params, {"tokens": tokens, **extra}, cache)
        launches[backend] = flash_attention.launches - before
        nxt, out = logits[backend][:, -1].argmax(-1), []
        for i in range(4):
            step, cache = model.decode_step(params, cache, nxt[:, None], off + 9 + i)
            nxt = step[:, -1].argmax(-1)
            out.append(nxt)
        toks[backend] = torch.stack(out, 1)
        assert flash_attention.launches - before == launches[backend]
    assert launches == {"auto": _k4_per_prefill(cfg), "torch": 0}
    torch.testing.assert_close(logits["auto"], logits["torch"], rtol=1e-4, atol=1e-4)
    assert torch.equal(toks["auto"], toks["torch"])


# ---------------------------------------------------------------------------
# K4 at the tensor-core tile edges (3xTF32 mma.sync, 64-row/64-key tiles,
# 16-row warps, 8-key groups, head dims padded to a power of two)
# ---------------------------------------------------------------------------

K4_EDGE_PAIRS = ((1, 15), (15, 16), (16, 17), (17, 63), (63, 64), (64, 65), (65, 127),
                 (127, 129), (129, 2048), (2048, 1), (64, 17), (129, 63), (16, 16),
                 (2048, 2048))
K4_EDGE_DIMS = (8, 24, 40, 64, 72, 128)


@pytest.mark.parametrize("s_t", K4_EDGE_PAIRS, ids=lambda p: f"S{p[0]}-T{p[1]}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_cuda_tile_edges(cuda_device, s_t, dtype, causal):
    """K4 against its plain version where the tensor-core tiles are ragged:
    S and T one below, at and one above the 16-row, 64-row and 64-key tile
    edges, S != T, at every head dim class the kernel pads (f32 within
    2e-5 abs + rel; bf16 within one ulp of the output plus 2e-5)."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    s, t = s_t
    for d in K4_EDGE_DIMS:
        q, k, v = _qkv((1, 2, s, t, d), dtype, cuda_device, seed=s * 7 + t + d)
        got = flash_attention(q, k, v, causal=causal, block_q=s, block_kv=t)
        want = flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all()), d
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5, msg=f"D={d}")
        else:
            w = want.float()
            ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
            assert bool(((got.float() - w).abs() <= ulp + 2e-5).all()), d


# ---------------------------------------------------------------------------
# K1's compile-time instance (the default sobel5, v2) against its
# run-time-taps instance and edge_plain
# ---------------------------------------------------------------------------

K1_INSTANCE_CASES = (((1, 1), (8, 32)), ((2, 3), (16, 32)), ((37, 53), (16, 32)),
                     ((70, 270), (64, 256)), ((130, 301), (32, 128)), ((237, 413), (64, 96)))


@pytest.mark.parametrize("directions", (2, 4))
@pytest.mark.parametrize("out_nms", (False, True), ids=["plain", "nms"])
@pytest.mark.parametrize("kind", ("u8", "f32", "rgb", "rgb_f32", "int"))
def test_edge_cuda_instances_equal_plain(cuda_device, kind, out_nms, directions):
    spec = get_operator("sobel5")
    assert ekern.const_taps_instance(spec, "v2", directions)
    lane = dict(precision="int") if kind == "int" else {}
    extras = (dict(out_components=True, out_mag=True, with_max=True) if out_nms
              else dict(out_components=True, with_max=True))
    for shape, (bh, bw) in K1_INSTANCE_CASES:
        x = _frames("u8" if kind == "int" else kind, (2,) + shape, cuda_device)
        for padding in ("reflect", "edge", "zero"):
            for extra in (dict(with_max=True), extras):
                kw = dict(spec=spec, variant="v2", directions=directions, padding=padding,
                          block_h=bh, block_w=bw, rgb=kind.startswith("rgb"), out_nms=out_nms,
                          **lane, **extra)
                want = ekern.edge_plain(x, **kw)
                before = ekern.edge_cuda.const_launches
                const = ekern.edge_cuda(x, **kw)
                assert ekern.edge_cuda.const_launches == before + 1
                runtime = ekern.edge_cuda(x, instance="runtime", **kw)
                assert ekern.edge_cuda.const_launches == before + 1
                for got in (const, runtime):
                    got = got if isinstance(got, tuple) else (got,)
                    ref = want if isinstance(want, tuple) else (want,)
                    assert len(got) == len(ref)
                    assert all(torch.equal(a, b) for a, b in zip(got, ref)), (shape, padding)


def test_edge_stream_cuda_instances_agree(cuda_device):
    """K3 runs K1's tile body: both instances equal its plain version."""
    spec = get_operator("sobel5")
    rng = np.random.default_rng(5)
    x = _frames("u8", (2, 130, 301), cuda_device)
    n, h, w, bh, bw = 2, 130, 301, 32, 128
    gh, gw = -(-h // bh), -(-w // bw)
    prev = torch.rand((n, h, w), device=cuda_device) * 50
    prev_max = torch.rand((n, gh, gw), device=cuda_device) * 50
    mask = torch.from_numpy(rng.integers(0, 2, (n, gh, gw)).astype(np.int32)).to(cuda_device)
    for out_nms in (False, True):
        kw = dict(spec=spec, variant="v2", directions=4, block_h=bh, block_w=bw, out_nms=out_nms)
        want = ekern.edge_stream_plain(x, prev, prev_max, mask, **kw)
        for inst in ("auto", "runtime"):
            got = ekern.edge_stream_cuda(x, prev, prev_max, mask, instance=inst, **kw)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (out_nms, inst)


def _stream_masks(n, gh, gw, device):
    """chip_smoke.py phase 2c's masks: none, all, random, a clustered block
    (the motion run's shape), one tile, only the last (ragged) tile."""
    rng = np.random.default_rng(18)
    masks = {k: v.cpu().numpy() for k, v in _masks(n, gh, gw, device).items()}
    block = np.zeros((n, gh, gw), np.int32)
    block[:, gh // 3: gh // 3 + max(1, gh // 4), gw // 4: gw // 4 + max(1, gw // 2)] = 1
    single = np.zeros((n, gh, gw), np.int32)
    single.flat[int(rng.integers(single.size))] = 1
    last = np.zeros((n, gh, gw), np.int32)
    last.flat[-1] = 1
    masks.update(block=block, single=single, last=last)
    return {k: torch.from_numpy(v.astype(np.int32)).to(device) for k, v in masks.items()}


def _row_offset(t):
    """A contiguous copy of (n, h, w) ``t`` one row into a larger buffer."""
    n, h, w = t.shape
    buf = torch.empty((n * h + 1) * w, dtype=t.dtype, device=t.device)
    out = buf[w:].view(n, h, w)
    out.copy_(t)
    return out


@pytest.mark.parametrize("mask_kind", ("none", "all", "random", "block", "single", "last"))
@pytest.mark.parametrize("case", [
    ("u8", (2, 37, 53), (16, 32), False, 0),
    ("u8", (4, 512, 512), (8, 8), False, 1),     # 16,384 tiles: more than one scan chunk
    ("f32", (2, 37, 53), (16, 32), True, 0),     # caches off 16 bytes: scalar copies
    ("u8", (2, 256, 512), (64, 256), False, 1),  # the stream server's tile: vector copies
    ("rgb", (1, 1, 1), (8, 8), False, 0),
], ids=("37x53", "512x512-8x8", "37x53-row-offset", "256x512-64x256", "1x1"))
@pytest.mark.parametrize("out_nms", (False, True), ids=("mag", "nms"))
def test_edge_stream_cuda_masks_and_copy_routes(cuda_device, out_nms, case, mask_kind):
    """K3 on chip_smoke.py phase 2c's masks, both instances, equals its
    plain version (K1 on an all-1 mask, the caches on an all-0 one), and
    copies by 16-byte vectors exactly where stream_vector_copy says."""
    kind, shape, (bh, bw), offset, vec = case
    n, h, w = shape
    x = _frames(kind, shape, cuda_device)
    gh, gw = -(-h // bh), -(-w // bw)
    prev = torch.rand((n, h, w), device=cuda_device) * 50
    if offset:
        prev = _row_offset(prev)
        assert prev.data_ptr() % 16 != 0
    prev_max = torch.rand((n, gh, gw), device=cuda_device) * 50
    mask = _stream_masks(n, gh, gw, cuda_device)[mask_kind]
    kw = dict(spec=get_operator("sobel5"), variant="v2", directions=4, block_h=bh, block_w=bw,
              rgb=kind == "rgb", out_nms=out_nms)
    want = ekern.edge_stream_plain(x, prev, prev_max, mask, **kw)
    for inst in ("auto", "runtime"):
        before = (ekern.edge_stream_cuda.launches, ekern.edge_stream_cuda.vector_launches)
        got = ekern.edge_stream_cuda(x, prev, prev_max, mask, instance=inst, **kw)
        assert (ekern.edge_stream_cuda.launches - before[0],
                ekern.edge_stream_cuda.vector_launches - before[1]) == (1, vec)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), inst
        if mask_kind == "all":
            k1 = ekern.edge_cuda(x, with_max=True, instance=inst, **kw)
            assert torch.equal(got[0], k1[0]) and torch.equal(got[1], k1[1])
        if mask_kind == "none":
            assert torch.equal(got[0], prev) and torch.equal(got[1], prev_max)


def test_edge_stream_cuda_on_two_streams_at_once(cuda_device):
    """Two streams' K3 launches overlap, each claiming from its own counter,
    and each equals its plain version; so do the launches after them."""
    kind, shape, (bh, bw) = "u8", (4, 512, 512), (8, 8)
    n, h, w = shape
    gh, gw = -(-h // bh), -(-w // bw)
    x = _frames(kind, shape, cuda_device)
    kw = dict(spec=get_operator("sobel5"), variant="v2", directions=4, block_h=bh, block_w=bw,
              out_nms=True)
    masks = _stream_masks(n, gh, gw, cuda_device)
    prev = torch.rand((n, h, w), device=cuda_device) * 50
    prev_max = torch.rand((n, gh, gw), device=cuda_device) * 50
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    torch.cuda.synchronize()
    for _ in range(3):
        got = []
        for stream, name in zip(streams, ("random", "block")):
            with torch.cuda.stream(stream):
                got.append((name, ekern.edge_stream_cuda(x, prev, prev_max, masks[name], **kw)))
        torch.cuda.synchronize()
        for name, (primary, bmax) in got:
            want = ekern.edge_stream_plain(x, prev, prev_max, masks[name], **kw)
            assert torch.equal(primary, want[0]) and torch.equal(bmax, want[1]), name


@pytest.mark.parametrize("out_nms", (False, True), ids=["plain", "nms"])
@pytest.mark.parametrize("kind", ("u8", "f32", "int"))
def test_edge_cuda_tiles_wider_than_one_cta_pass(cuda_device, kind, out_nms):
    """Tiles wider than one pass of K1's CTA (384 threads, or 12 warps of
    30 centre columns with NMS) loop over their columns; a full-width tile
    (``block_w=None``) does too. Both instances equal edge_plain."""
    spec = get_operator("sobel5")
    lane = dict(precision="int") if kind == "int" else {}
    x = _frames("u8" if kind == "int" else kind, (2, 37, 1000), cuda_device)
    for bh, bw in ((8, 512), (16, None)):
        kw = dict(spec=spec, variant="v2", directions=4, block_h=bh, block_w=bw,
                  out_nms=out_nms, with_max=True, **lane)
        want = ekern.edge_plain(x, **kw)
        for inst in ("auto", "runtime"):
            got = ekern.edge_cuda(x, instance=inst, **kw)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (bh, bw, inst)


# --- stencil plans: pre-stages fused into K1 and K2 --------------------------

def _plans():
    from repro_torch.core.filters import get_plan, make_plan, pointwise_stage

    return {
        "canny5": get_plan("canny5"),
        "blur_sobel5": get_plan("blur_sobel5"),
        "g3_dilate_sobel5_nms": make_plan("g3d", ("gaussian3", "dilate3", "sobel5", "nms")),
        "erode_abs_sobel3": make_plan("ea", ("erode3", pointwise_stage("abs", "abs"),
                                             "sobel3")),
        "square_g3_scharr3_nms": make_plan("sq", (pointwise_stage("square", "square"),
                                                  "gaussian3", "scharr3", "nms")),
    }


@pytest.mark.parametrize("name", sorted(_plans()))
@pytest.mark.parametrize("kind", ("u8", "f32", "rgb", "rgb_f32"))
def test_plans_on_k1_and_k2_equal_plain(cuda_device, kind, name):
    """One K1 or K2 launch with the plan's pre-stages equals edge_plain(plan=)
    bit for bit, every padding, on two tiles and K2 depths 2 and 3."""
    plan = _plans()[name]
    spec = plan.gradient
    x = _frames(kind, (2, 37, 53), cuda_device)
    extra = (dict(out_nms=True, out_components=True, out_mag=True, with_max=True) if plan.nms
             else dict(out_components=True, with_max=True))
    for padding in ("reflect", "edge", "zero"):
        for bh, bw in ((8, 32), (32, 64)):
            kw = dict(plan=plan, variant=spec.resolve_variant("auto"),
                      directions=spec.resolve_directions(0), padding=padding, block_h=bh,
                      block_w=bw, rgb=kind.startswith("rgb"), **extra)
            want = ekern.edge_plain(x, **kw)
            for depth in (0, 2, 3):
                k1, k2 = ekern.edge_cuda.plan_launches, ekern.edge_pipelined_cuda.plan_launches
                got = ekern.edge_cuda(x, pipeline_depth=depth, **kw)
                assert all(torch.equal(a, b) for a, b in zip(got, want)), (padding, bh, bw, depth)
                assert (ekern.edge_cuda.plan_launches - k1,
                        ekern.edge_pipelined_cuda.plan_launches - k2) == (
                    (0, 1) if depth else (1, 0))


def test_plan_facade_is_one_launch(cuda_device):
    x = _frames("u8", (4, 256, 512), cuda_device)
    cfg = EdgeConfig(plan="canny5", hysteresis=True, block_h=64, block_w=256)
    k1, k2 = ekern.edge_cuda.launches, ekern.edge_pipelined_cuda.launches
    res = edge_detect(x, cfg)
    assert (ekern.edge_cuda.launches - k1, ekern.edge_pipelined_cuda.launches - k2) == (1, 0)
    ref = edge_detect(x, cfg.replace(backend="torch"))
    assert torch.equal(res.magnitude, ref.magnitude) and torch.equal(res.edges, ref.edges)


def test_plan_footprint_matches_the_source_and_over_budget_raises(cuda_device):
    lib = ekern._lib("edge_pipelined")
    for plan in _plans().values():
        for bh, bw in ((8, 32), (64, 256), (29, 96)):
            for depth in ekern.PIPELINE_DEPTHS:
                for in_bytes, channels in ((1, 1), (4, 1), (1, 3)):
                    for nms in (False, True):
                        want = ekern.pipelined_smem_bytes(bh, bw, plan.gradient.radius, depth,
                                                          in_bytes, channels, nms, plan=plan)
                        got = lib.repro_pipelined_plan_smem_bytes(
                            bh, bw, plan.linear_reach, depth, in_bytes, channels, int(nms),
                            ekern.pre_plane_words(bh, bw, plan, nms))
                        assert got == want, (plan.name, bh, bw, depth, in_bytes, channels, nms)
    x = _frames("f32", (1, 256, 512), cuda_device)
    with pytest.raises(ValueError, match="pre-stage plane"):
        ekern.edge_cuda(x, plan="canny5", variant="v2", directions=4, block_h=64,
                        block_w=256, out_nms=True, pipeline_depth=2)


SHARD_CONFIGS = (
    dict(with_max=True, with_components=True, with_orientation=True),
    dict(operator="scharr3", padding="zero", with_max=True),
    dict(nms=True, hysteresis=True, with_max=True),
    dict(plan="canny5", hysteresis=True, with_max=True),
    dict(with_max=True, pipeline_depth=2),
)


@pytest.mark.parametrize("config", SHARD_CONFIGS, ids=str)
@pytest.mark.parametrize("kind", ("u8", "f32", "rgb"))
@pytest.mark.parametrize("spec", ("8x1x1", "2x2x2", "1x4x2"))
def test_sharded_facade_on_logical_devices(cuda_device, spec, kind, config):
    """K1 (or K2 at a depth) once per shard on ``[cuda:0] * 8``: the sharded
    call equals the single-device call and the torch lane bit for bit."""
    from repro_torch.api import ShardConfig
    from repro_torch.sharding.halo import mesh_from_config

    x = _frames(kind, (3, 237, 413), cuda_device)
    cfg = EdgeConfig(block_h=32, block_w=64, **config)
    mesh = mesh_from_config(ShardConfig.parse(spec), [torch.device("cuda:0")] * 8)
    single = edge_detect(x, cfg)
    k1, k2 = ekern.edge_cuda.launches, ekern.edge_pipelined_cuda.launches
    out = edge_detect(x, cfg, mesh=mesh)
    depth = bool(config.get("pipeline_depth"))
    assert (ekern.edge_cuda.launches - k1, ekern.edge_pipelined_cuda.launches - k2) == (
        (0, 8) if depth else (8, 0))
    plain = edge_detect(x, cfg.replace(backend="torch"), mesh=mesh)
    for field in ("magnitude", "components", "orientation", "peak", "thin", "edges"):
        a, b, c = getattr(out, field), getattr(single, field), getattr(plain, field)
        assert (a is None) == (b is None) == (c is None), field
        if a is not None:
            assert a.device.type == "cuda" and torch.equal(a, b) and torch.equal(a, c), field


# --- The contract analyzer's card half (repro_torch.analysis) ---------------
#
# The tests that profile come first and profile in quick succession, the
# compiled code read before: on the H100 the profiler returns short windows
# without their device records once its process profiled and then went
# ~30 s without (tools/profiler_idle.py; the analyzer's own device programs
# run in a child process for that).

ROOT_BASELINE = __import__("pathlib").Path(__file__).resolve().parents[1] / \
    "analysis_baseline_torch.json"


@pytest.fixture(scope="module")
def static_smem():
    """Each K1-K3 instance's static shared memory, read from the compiled
    code before any test of this section profiles."""
    from repro_torch.analysis import device

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    progs = device.compiled_programs()
    return {k: v for prog in progs.values() for k, v in prog.static_smem.items()}


def _profiled_kernels(fn):
    from repro_torch.analysis import device
    from repro_torch.kernels import build

    fn()
    torch.cuda.synchronize()
    return device.profile_call(fn, build.BUILD_DIR / "analysis")


@pytest.mark.parametrize("which", ("k1", "k1-nms", "k2", "k3"))
def test_fuse003_one_kernel_per_wrapper_call(cuda_device, static_smem, which):
    """One wrapper call is exactly one edge kernel on the device: no pad,
    copy or memset beside it, and its dynamic shared memory is the
    allocation model's."""
    from repro_torch.analysis import check_device_program, device

    spec = get_operator("sobel5")
    x = _frames("u8", (2, 237, 413), cuda_device)
    kw = dict(spec=spec, variant="v2", directions=4, block_h=32, block_w=64)
    if which == "k3":
        n, h, w = x.shape
        gh, gw = -(-h // 32), -(-w // 64)
        prev = torch.zeros((n, h, w), device=cuda_device)
        bmax = torch.zeros((n, gh, gw), device=cuda_device)
        mask = torch.ones((n, gh, gw), dtype=torch.int32, device=cuda_device)
        acts = _profiled_kernels(lambda: ekern.edge_stream_cuda(x, prev, bmax, mask, **kw))
        kernel, smem = "stream_kernel", ekern.launch_smem_bytes(32, 64, 2)
    elif which == "k2":
        acts = _profiled_kernels(lambda: ekern.edge_pipelined_cuda(x, pipeline_depth=2, **kw))
        kernel, smem = "pipelined_kernel", ekern.pipelined_smem_bytes(32, 64, 2, 2, 1, 1, False)
    else:
        nms = which == "k1-nms"
        acts = _profiled_kernels(lambda: ekern.edge_cuda(x, out_nms=nms, with_max=True, **kw))
        kernel, smem = "edge_kernel", ekern.launch_smem_bytes(32, 64, 2, nms)
    assert check_device_program([a["name"] for a in acts], location=which, kernel=kernel) == []
    assert len(acts) == 1, acts
    assert acts[0]["smem"] - static_smem[device.instance_key(acts[0]["name"])] == smem


def test_analyzer_cuda_sweep_is_clean(cuda_device):
    """The fast sweep on both lanes, every card half run: no new violation
    against the committed baseline, no rule left unrun, K1-K3 launched."""
    from repro_torch.analysis import analyze, load_baseline

    launches = (ekern.edge_cuda.launches, ekern.edge_pipelined_cuda.launches,
                ekern.edge_stream_cuda.launches)
    report = analyze(backends=("torch", "cuda"))
    report.apply_baseline(load_baseline(str(ROOT_BASELINE)))
    assert report.ok, report.render()
    assert report.meta["not_run"] == {}
    assert all(now > then for now, then in zip(
        (ekern.edge_cuda.launches, ekern.edge_pipelined_cuda.launches,
         ekern.edge_stream_cuda.launches), launches))
    assert all(row["fma.rn.f32"] == 0 for row in report.meta["instances"].values())


def test_listings_hold_every_instance_the_wrappers_launch(cuda_device):
    """The SASS, PTX and resource-usage parsers find all 84 K1-K3 instances
    (``compiled_program`` raises on a missing one); each K2 instance has
    its ring's copies and try-waits; no instance has ``fma.rn.f32``."""
    from repro_torch.analysis import device

    progs = device.compiled_programs()
    found = set()
    for lib, prog in progs.items():
        assert prog.functions["sass"] >= len(prog.sass) and prog.functions["ptx"] >= len(prog.ptx)
        found |= set(prog.sass) & set(prog.ptx) & set(prog.static_smem)
        for key, ops in prog.sass.items():
            assert "fma.rn.f32" not in prog.ptx[key], key
            if lib == "edge_pipelined":
                copies, waits = device.sass_ring_sites(ops)
                assert copies > 0 and waits > 0, (key, copies, waits)
    assert found >= {i.key for i in device.launchable_instances()}


@pytest.mark.parametrize("nms", (False, True))
@pytest.mark.parametrize("op", ("sobel3", "sobel5", "sobel7", "sep9"))
@pytest.mark.parametrize("which", ("k1", "k2", "k3"))
def test_impulse_probe_measures_window_radius(cuda_device, which, op, nms):
    """HALO001 on the card: impulses at 0..R+1 rows and columns from a tile
    border move K1's, K2's and K3's output exactly ``window_radius`` away."""
    from repro_torch.analysis import impulse_reach
    from repro_torch.kernels.tiling import window_radius

    spec = get_operator(op)
    kw = dict(spec=spec, variant=spec.resolve_variant("auto"), directions=max(spec.directions),
              block_h=16, block_w=32)

    def fn(xb):
        if which == "k3":
            n, h, w = xb.shape
            gh, gw = -(-h // 16), -(-w // 32)
            return ekern.edge_stream_cuda(
                xb, torch.zeros((n, h, w), device=cuda_device),
                torch.zeros((n, gh, gw), device=cuda_device),
                torch.ones((n, gh, gw), dtype=torch.int32, device=cuda_device),
                out_nms=nms, **kw)[0]
        return ekern.edge_cuda(xb, out_nms=nms, pipeline_depth=2 if which == "k2" else 0, **kw)

    r = window_radius(spec.radius, nms)
    assert impulse_reach(fn, (80, 128), border=(32, 64), offsets=r + 2,
                         device=cuda_device) == (r, r)


def test_fig7_ssim_on_the_card(cuda_device):
    """Fig. 7: K1's unnormalized magnitude against the dense oracle on the
    plain lane, SSIM > 0.999999 for each ladder variant."""
    from repro_torch.core.ssim import ssim
    from repro_torch.kernels.ref import sobel_ref

    x = _frames("f32", (2, 512, 640), cuda_device)
    ref = sobel_ref(x)
    for variant in ("separable", "v1", "v2"):
        launches = ekern.edge_cuda.launches
        mag = edge_detect(x, EdgeConfig(variant=variant, normalize=False, block_h=64,
                                        block_w=128)).magnitude
        assert ekern.edge_cuda.launches == launches + 1
        assert float(ssim(mag, ref).mean()) > 0.999999, variant


# ---------------------------------------------------------------------------
# Training: K4 and K5 under autograd (their Functions), and a step on the card
# ---------------------------------------------------------------------------

# K4's forward against the plain version (phase 6's tolerances: f32 2e-5,
# bf16 one ulp + 2e-5); the backward recomputes the plain version, so the
# gradients differ from plain autograd's only by the products' order on the
# card: within 1e-5 of each gradient's largest value.
K4_FWD_TOL, GRAD_REL = 2e-5, 1e-5


def _bf16_ulp(x):
    return torch.exp2(torch.floor(torch.log2(x.float().abs().clamp_min(1e-30))) - 7)


@pytest.mark.parametrize("shape,causal", [((8, 32, 128, 128, 64), True),
                                          ((2, 20, 64, 300, 64), False),
                                          ((1, 3, 37, 37, 8), True)],
                         ids=["llama-train", "noncausal", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k4_function_on_the_card_gives_the_plain_gradients(cuda_device, shape, causal, dtype):
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain, \
        k4_attention

    b, h, s, t, d = shape
    g = torch.Generator(device=cuda_device).manual_seed(s * t)
    q, k, v = (torch.randn(n, generator=g, device=cuda_device).to(dtype).requires_grad_()
               for n in ((b, h, s, d), (b, h, t, d), (b, h, t, d)))
    go = torch.randn((b, h, s, d), generator=g, device=cuda_device).to(dtype)
    before = flash_attention.launches
    out = k4_attention(q, k, v, causal=causal, block_q=s, block_kv=t)
    got = torch.autograd.grad(out, (q, k, v), go)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    plain = flash_attention_plain(q, k, v, causal=causal)
    want = torch.autograd.grad(plain, (q, k, v), go)
    err = (out.float() - plain.float()).abs()
    bound = K4_FWD_TOL + (_bf16_ulp(plain) if dtype == torch.bfloat16 else 0.0)
    assert bool((err <= bound).all())
    for a, w in zip(got, want):
        assert float((a.float() - w.float()).abs().max()) <= GRAD_REL * float(
            w.float().abs().max())


def test_k5_function_on_the_card_gives_the_plain_gradients(cuda_device):
    from repro_torch.kernels.selective_scan import k5_scan, selective_scan, selective_scan_plain

    shape = (1, 128, 512, 16)
    args = [t.requires_grad_() for t in _scan_inputs(shape, torch.float32, cuda_device)]
    gy = torch.randn(shape[:3], device=cuda_device)
    gh = torch.randn((1, 512, 16), device=cuda_device)
    before = selective_scan.launches
    y, h = k5_scan(*args, chunk=128, block_d=512)
    got = torch.autograd.grad((y, h), args, (gy, gh))
    torch.cuda.synchronize()
    assert selective_scan.launches == before + 1
    want = torch.autograd.grad(selective_scan_plain(*args), args, (gy, gh))
    for a, w in zip(got, want):
        assert float((a - w).abs().max()) <= GRAD_REL * float(w.abs().max())


def test_bare_kernel_calls_under_autograd_raise(cuda_device):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.selective_scan import selective_scan

    q = torch.randn(1, 2, 16, 64, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="k4_attention"):
        flash_attention(q, q, q)
    with torch.no_grad():
        flash_attention(q, q, q)
    args = [t.requires_grad_() for t in _scan_inputs((1, 8, 32, 4), torch.float32, cuda_device)]
    with pytest.raises(RuntimeError, match="k5_scan"):
        selective_scan(*args, chunk=8, block_d=32)


@pytest.mark.parametrize("arch", ("llama3.2-1b", "falcon-mamba-7b", "whisper-large-v3"))
def test_a_training_step_on_the_card_lane_matches_the_plain_lane(cuda_device, arch):
    """SMOKE f32: one step's loss and gradients through K4 (K5 for the ssm
    model) against the plain lane on the card; the kernels launch once a
    layer (whisper: encoder, decoder and cross-attention) in the forward and
    once more in the backward (remat's recompute)."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.selective_scan import selective_scan
    from repro_torch.models import Model, remat
    from repro_torch.tree import leaves, unflatten

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    params = Model(cfg).init(1, device=cuda_device)
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in lm_batch(cfg, 2, 32).items()}

    def step(backend):
        flat = [p.clone().requires_grad_(True) for p in leaves(params)]
        loss, _ = Model(cfg, backend=backend).loss_fn(unflatten(params, flat), batch)
        return loss.detach(), torch.autograd.grad(loss, flat, allow_unused=True)

    k4, k5 = flash_attention.launches, selective_scan.launches
    loss, grads = step("auto")
    torch.cuda.synchronize()
    launched = (flash_attention.launches - k4, selective_scan.launches - k5)
    want = {"ssm": (0, cfg.num_layers), "encdec": (cfg.encoder_layers + 2 * cfg.num_layers, 0)}
    runs = remat.forward_runs(cfg)
    assert launched == tuple(n * runs for n in want.get(cfg.family, (cfg.num_layers, 0)))
    plain_loss, plain = step("torch")
    assert abs(float(loss) - float(plain_loss)) <= 1e-4
    for g, w in zip(grads, plain):
        if w is not None:
            assert float((g - w).abs().max()) <= 1e-3 * float(w.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "falcon-mamba-7b", "minicpm3-4b",
                                  "qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b"])
def test_a_training_step_on_a_mesh_of_the_card_matches_one_device(cuda_device, arch):
    """SMOKE f32 on a 2x2 (data, model) mesh of ``[cuda] * 4``: K4 (K5 for
    the ssm family) once a layer a position, twice under remat, and no
    other kernel, the loss
    (a moe model's aux terms with it) and every gathered gradient against
    the one-device step on the card, every shard on the card."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.selective_scan import selective_scan
    from repro_torch.models import Model, remat
    from repro_torch.runtime.elastic import make_mesh
    from repro_torch.sharding.placed import gather, place
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.tree import leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    tc = TrainConfig(batch=4, seq_len=32)
    params = Model(cfg).init(1, device=cuda_device)
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in lm_batch(cfg, 4, 32).items()}
    want, want_m = Trainer(cfg, tc, device=cuda_device).grads_of(params, batch)
    mesh = make_mesh([cuda_device] * 4, model_parallel=2)
    trainer = Trainer(cfg, tc, mesh=mesh)
    placed = tree_map(place, params, trainer.state_shardings().params)
    before = (flash_attention.launches, selective_scan.launches)
    got, got_m = trainer.mesh_grads_of(placed, trainer._microbatches(batch)[0])
    torch.cuda.synchronize()
    launched = (flash_attention.launches - before[0], selective_scan.launches - before[1])
    per_step = cfg.num_layers * mesh.size * remat.forward_runs(cfg)
    assert launched == ((0, per_step) if cfg.family == "ssm" else (per_step, 0))
    assert set(got_m) == set(want_m)
    for k in want_m:
        assert abs(float(got_m[k]) - float(want_m[k])) <= 1e-4 * abs(float(want_m[k])), k
    for g, w in zip(leaves(got), leaves(want)):
        assert all(t.device.type == "cuda" for t in g.shards.values())
        assert float((gather(g) - w).abs().max()) <= 1e-3 * float(w.abs().max().clamp_min(1e-30))
