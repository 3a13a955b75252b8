"""The streaming detector of the port against the reference, bit for bit.

``edge_detect_stream`` sequences (static, partial motion, sensor noise;
decay 0 and 0.9; gray and RGB) are held step by step against
``repro.api.edge_detect_stream`` on the reference's XLA lane: magnitude,
edges, skipped tiles and the carried state (``primary``, ``bmax``,
``seed``). The grids compare because every config pins its tile. The
cached path, the change test and the ``StreamEngine`` (with its health
ledger under a fault plan) are held against the reference's too. Frames are
made from a seed with numpy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import EdgeConfig as RefConfig
from repro.api import edge_detect_stream as ref_stream
from repro.configs import get_config as ref_get_config
from repro.data.synthetic import video_frame as ref_video_frame
from repro.kernels import dispatch as ref_dispatch
from repro.runtime.chaos import FaultPlan as RefFaultPlan
from repro.serve import StreamEngine as RefEngine
from repro.serve import StreamRequest as RefRequest
from repro_torch.api import EdgeConfig, StreamState, edge_detect, edge_detect_stream
from repro_torch.configs import get_config
from repro_torch.core.filters import get_operator
from repro_torch.data.synthetic import video_frame
from repro_torch.kernels import dispatch
from repro_torch.kernels import edge as ekern
from repro_torch.runtime.chaos import FaultPlan
from repro_torch.serve import StreamEngine, StreamRequest

H, W = 64, 96


def _small(cfg_fn):
    return cfg_fn("sobel-hd", smoke=True).replace(image_h=H, image_w=W)


def _sequence(kind, rgb, n=5):
    """Frames of one stream: a textured background with a moving disk."""
    cfg = _small(get_config)
    motion = {"static": 0.0, "motion": 3.0, "noise": 0.0}[kind]
    noise = 4.0 if kind == "noise" else 0.0
    frames = [video_frame(cfg, stream=1, step=t, motion=motion, noise=noise) for t in range(n)]
    if rgb:
        frames = [np.stack([f, 255 - f, f // 2], axis=-1) for f in frames]
    return frames


def _eq(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=what)


def _assert_step(res, st, ref_res, ref_st, what):
    _eq(res.magnitude, ref_res.magnitude, f"{what} magnitude")
    for field in ("thin", "edges", "skipped", "peak"):
        a, b = getattr(res, field), getattr(ref_res, field)
        assert (a is None) == (b is None), field
        if a is not None:
            _eq(a, b, f"{what} {field}")
    for field in ("frame", "primary", "bmax", "seed"):
        a, b = getattr(st, field), getattr(ref_st, field)
        assert (a is None) == (b is None), field
        if a is not None:
            _eq(a, b, f"{what} state.{field}")
    assert st.block == ref_st.block and st.initialized == ref_st.initialized


@pytest.mark.parametrize("rgb", (False, True), ids=("gray", "rgb"))
@pytest.mark.parametrize("decay", (0.0, 0.9))
@pytest.mark.parametrize("kind", ("static", "motion", "noise"))
def test_stream_sequence_matches_reference(kind, decay, rgb):
    kw = dict(nms=True, hysteresis=True, with_max=True, block_h=8, block_w=8)
    if decay:
        kw.update(temporal=True, decay=decay)
    cfg, ref_cfg = EdgeConfig(**kw), RefConfig(backend="xla", **kw)
    state = ref_state = None
    skipped = []
    for t, f in enumerate(_sequence(kind, rgb)):
        res, state = edge_detect_stream(f, cfg, state, device="cpu")
        ref_res, ref_state = ref_stream(f, ref_cfg, ref_state)
        _assert_step(res, state, ref_res, ref_state, f"{kind} t={t}")
        skipped.append(int(res.skipped))
    assert skipped[0] == 0
    if kind == "static":
        assert skipped[1:] == [state.tiles] * 4
    elif kind == "motion":
        assert all(0 < s < state.tiles for s in skipped[1:]), skipped
    else:
        assert skipped[1:] == [0] * 4


@pytest.mark.parametrize("block", ((8, 8), (16, 24), (13, 20), (64, 256)),
                         ids=lambda b: f"{b[0]}x{b[1]}")
def test_stream_batch_ragged_tiles_match_reference(block):
    """A batch of streams on ragged tiles, a magnitude-only config, and a
    one-pixel change at a tile corner."""
    cfg_kw = dict(block_h=block[0], block_w=block[1], normalize=False, with_max=True)
    cfg, ref_cfg = EdgeConfig(**cfg_kw), RefConfig(backend="xla", **cfg_kw)
    rng = np.random.default_rng(block[0])
    f0 = rng.integers(0, 256, (3, 37, 53)).astype(np.uint8)
    f1 = f0.copy()
    f1[1, block[0] % 37, block[1] % 53] ^= 0xFF
    f2 = f1.copy()
    f2[2] = 255 - f2[2]
    state = ref_state = None
    for t, f in enumerate((f0, f1, f2, f2)):
        res, state = edge_detect_stream(f, cfg, state, device="cpu")
        ref_res, ref_state = ref_stream(f, ref_cfg, ref_state)
        _assert_step(res, state, ref_res, ref_state, f"t={t}")


def test_decay0_stream_equals_stateless_detect():
    """DESIGN.md section 8: with decay 0 the stream output equals stateless
    edge_detect frame by frame."""
    cfg = EdgeConfig(nms=True, temporal=True, decay=0.0, block_h=16, block_w=16)
    stateless = cfg.replace(temporal=False, hysteresis=True)
    state = None
    for f in _sequence("motion", False, n=6):
        res, state = edge_detect_stream(f, cfg, state, device="cpu")
        ref = edge_detect(f, stateless, device="cpu")
        assert torch.equal(res.magnitude, ref.magnitude) and torch.equal(res.edges, ref.edges)


def test_cached_path_matches_reference():
    kw = dict(nms=True, temporal=True, decay=0.9, block_h=16, block_w=16)
    cfg, ref_cfg = EdgeConfig(**kw).resolved(), RefConfig(backend="xla", **kw).resolved()
    f = _sequence("static", False, n=1)[0]
    _, state = edge_detect_stream(f, cfg, device="cpu")
    _, ref_state = ref_stream(f, ref_cfg)
    for t in range(3):
        res, state = dispatch.edge_stream_cached(cfg, state, layout="HW")
        ref_res, ref_state = ref_dispatch.edge_stream_cached(ref_cfg, ref_state, layout="HW")
        _assert_step(res, state, ref_res, ref_state, f"cached t={t}")
        assert int(res.skipped) == state.tiles
    # The cached step equals a computed step on the same static frame.
    full, _ = edge_detect_stream(f, cfg, state, device="cpu")
    cached, _ = dispatch.edge_stream_cached(cfg, state, layout="HW")
    assert torch.equal(full.edges, cached.edges) and torch.equal(full.magnitude, cached.magnitude)
    with pytest.raises(ValueError, match="initialized"):
        dispatch.edge_stream_cached(cfg, StreamState.init(1, H, W, cfg, device="cpu"))


@pytest.mark.parametrize("nms_on", (False, True))
def test_stream_delta_matches_reference(nms_on):
    rng = np.random.default_rng(17)
    for h, w, bh, bw in ((37, 53, 8, 16), (40, 56, 16, 16), (5, 7, 2, 3), (64, 64, 64, 256)):
        kw = dict(nms=nms_on, block_h=bh, block_w=bw)
        cfg, ref_cfg = EdgeConfig(**kw).resolved(), RefConfig(backend="xla", **kw).resolved()
        f0 = rng.integers(0, 256, (2, h, w)).astype(np.uint8)
        _, state = edge_detect_stream(f0, cfg, device="cpu")
        _, ref_state = ref_stream(f0, ref_cfg)
        for _ in range(4):
            f1 = f0.copy()
            for _ in range(rng.integers(1, 4)):
                f1[rng.integers(0, 2), rng.integers(0, h), rng.integers(0, w)] ^= 0x55
            changed, skipped = dispatch.stream_delta(torch.from_numpy(f1), state, cfg)
            ref_changed, ref_skipped = ref_dispatch.stream_delta(jnp.asarray(f1), ref_state,
                                                                 ref_cfg)
            _eq(changed, ref_changed, f"{h}x{w} block {bh}x{bw}")
            _eq(skipped, ref_skipped)


def test_window_reach_matches_reference():
    for n in (1, 5, 37, 53, 2048):
        for b in (1, 2, 8, 13, 64, 256):
            g = -(-n // b)
            for r in (1, 2, 3, 4, 5):
                t = min(b + 2 * r, n)
                assert dispatch._window_reach(n, b, g, t, r) == ref_dispatch._window_reach(
                    n, b, g, t, r), (n, b, r)


def test_stream_state_init_and_batching():
    cfg = EdgeConfig(temporal=True, block_h=16, block_w=16).resolved()
    st = StreamState.init(2, H, W, cfg, device="cpu")
    assert st.frame.shape == (2, H, W) and st.frame.dtype == torch.uint8
    assert st.primary.shape == (2, H, W) and st.seed.shape == (2, H, W)
    assert st.grid == (4, 6) and st.tiles == 24 and not st.initialized
    both = StreamState.concat([st.map(lambda a: a[:1]), st.map(lambda a: a[1:])])
    assert both.frame.shape == st.frame.shape and both.block == st.block
    assert StreamState.init(1, H, W, cfg.replace(temporal=False, decay=0.0),
                            device="cpu").seed is None


def test_stream_rejects_what_the_reference_rejects():
    f = np.zeros((16, 16), np.uint8)
    for bad in (dict(with_components=True), dict(with_orientation=True),
                dict(pipeline_depth=2), dict(precision="int")):
        with pytest.raises(ValueError):
            ref_stream(f, RefConfig(backend="xla", **bad))
        with pytest.raises(ValueError):
            edge_detect_stream(f, EdgeConfig(**bad), device="cpu")
    with pytest.raises(ValueError, match="video"):
        edge_detect_stream(np.zeros((2, 3, 16, 16), np.uint8), device="cpu")
    _, state = edge_detect_stream(f, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        edge_detect_stream(np.zeros((16, 17), np.uint8), state=state, device="cpu")


def test_no_device_means_cuda_for_the_stream_path():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the no-card path is what is tested")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        edge_detect_stream(np.zeros((8, 8), np.uint8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamEngine(EdgeConfig())
    with pytest.raises(ValueError, match="needs a CUDA device"):
        edge_detect_stream(np.zeros((8, 8), np.uint8), backend="cuda", device="cpu")


def test_edge_stream_cuda_raises_on_a_cpu_tensor():
    x = torch.zeros((1, 8, 8), dtype=torch.uint8)
    before = ekern.edge_stream_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        ekern.edge_stream_cuda(x, torch.zeros((1, 8, 8)), torch.zeros((1, 1, 1)),
                               torch.ones((1, 1, 1), dtype=torch.int32),
                               spec=get_operator("sobel5"), variant="v2", directions=4,
                               block_h=8, block_w=8)
    assert ekern.edge_stream_cuda.launches == before


def test_edge_stream_plain_checks_the_grid():
    x = torch.zeros((1, 8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="tile grid"):
        ekern.edge_stream_plain(x, torch.zeros((1, 8, 8)), torch.zeros((1, 2, 2)),
                                torch.ones((1, 1, 1), dtype=torch.int32),
                                spec=get_operator("sobel5"), variant="v2", directions=4,
                                block_h=8, block_w=8)


def test_video_frame_matches_reference():
    cfg, ref_cfg = _small(get_config), _small(ref_get_config)
    for kw in (dict(), dict(motion=0.0), dict(motion=3.0, noise=2.0, seed=4)):
        for step in (0, 5):
            _eq(video_frame(cfg, stream=2, step=step, **kw),
                ref_video_frame(ref_cfg, stream=2, step=step, **kw))


def _sources(make_request, cfg):
    """Three cameras of three resolutions: a moving and a static one at
    30 fps, a moving one at 15 fps."""
    static, small = cfg.replace(image_h=48, image_w=64), cfg.replace(image_h=32, image_w=40)
    specs = ((0, cfg, 3.0, 30.0, 5), (1, static, 0.0, 30.0, 4), (2, small, 2.0, 15.0, 3))
    reqs = []
    for sid, c, motion, fps, n in specs:
        def frame(i, c=c, sid=sid, motion=motion, n=n):
            return None if i >= n else ref_video_frame(c, stream=sid, step=i, motion=motion)
        reqs.append(make_request(sid=sid, frames=frame, fps=fps))
    return reqs


@pytest.mark.parametrize("chaos", (None, "fail@step:1x1;corrupt@0:2=nan;slow@s1:1@0-2"),
                         ids=("clean", "faults"))
def test_stream_engine_matches_reference_engine(chaos):
    kw = dict(nms=True, hysteresis=True, temporal=True, decay=0.9, with_max=True,
              block_h=16, block_w=16)
    ref_cfg = _small(ref_get_config)
    eng = StreamEngine(EdgeConfig(**kw), max_streams=2, collect=True, device="cpu",
                       chaos=FaultPlan.parse(chaos) if chaos else None)
    ref = RefEngine(RefConfig(backend="xla", **kw), max_streams=2, collect=True,
                    chaos=RefFaultPlan.parse(chaos) if chaos else None)
    for req in _sources(StreamRequest, ref_cfg):
        eng.submit(req)
    for req in _sources(RefRequest, ref_cfg):
        ref.submit(req)
    stats, ref_stats = eng.run(), ref.run()
    assert sorted(stats) == sorted(ref_stats) == [0, 1, 2]
    for sid in stats:
        a, b = stats[sid], ref_stats[sid]
        for f in ("frames", "submitted", "shed", "quarantined", "tiles_per_frame",
                  "skipped_tiles", "cached_steps", "shape"):
            assert getattr(a, f) == getattr(b, f), (sid, f)
        assert len(a.outputs) == len(b.outputs) == a.frames
        for t, (o, r) in enumerate(zip(a.outputs, b.outputs)):
            assert o["skipped"] == r["skipped"], (sid, t)
            _eq(o["magnitude"], r["magnitude"], f"stream {sid} frame {t}")
            _eq(o["edges"], r["edges"], f"stream {sid} frame {t}")
    h, rh = eng.health, ref.health
    assert h.counts == rh.counts and h.submitted == rh.submitted
    assert h.retries == rh.retries and h.unaccounted == 0 == rh.unaccounted
    assert h.backend == "torch" and not h.degraded
    assert stats[1].cached_steps >= 2  # the static camera takes the cached path
    if chaos:
        assert h.counts["retried"] >= 1 and h.counts["quarantined"] == 1


def test_guard_and_fault_plan_match_reference():
    """The copied runtime pieces behave as the reference's: the DSL parses
    to the same faults, the guard walks the same ladder, quarantine gives
    the same reasons."""
    from repro.runtime.chaos import FaultPlan as RP
    from repro.serve.guard import GuardPolicy as RG
    from repro.serve.guard import StepGuard as RS
    from repro.serve.guard import quarantine_reason as rq
    from repro_torch.serve.guard import GuardPolicy, StepGuard, quarantine_reason

    dsl = "loss@4=2;fail@step:1x2;fail@fallback:0xinf;slow@s1:40@2-5;corrupt@0:3=shape;seed=7"
    got, want = FaultPlan.parse(dsl), RP.parse(dsl)
    assert [(type(f).__name__, vars(f)) for f in got.faults] == [
        (type(f).__name__, vars(f)) for f in want.faults] and got.seed == want.seed
    frame = np.arange(48, dtype=np.uint8).reshape(6, 8)
    for mode in ("nan", "inf", "dtype", "shape"):
        _eq(got.corrupt(frame, mode), want.corrupt(frame, mode))
        bad = got.corrupt(frame, mode)
        assert quarantine_reason(bad, shape=(6, 8), dtype=np.uint8) == rq(
            bad, shape=(6, 8), dtype=np.uint8)

    def failing():
        raise RuntimeError("kernel refused")

    results = []
    for guard_cls, policy_cls in ((StepGuard, GuardPolicy), (RS, RG)):
        guard = guard_cls(failing, fallback=lambda: "plain", policy=policy_cls(),
                          sleep=lambda s: None)
        results.append((guard(), guard.degraded, guard.retries_total, guard()))
    assert results[0] == results[1] == (("plain", "degraded", 0), True, 3,
                                        ("plain", "degraded", 0))


def test_stream_engine_raises_when_its_kernel_keeps_failing(monkeypatch):
    """A kernel that fails past the retries raises out of the engine: no
    rung swaps the plain PyTorch lane in for it. The engine is built as it
    is on the card (backend ``cuda``); every ``edge_stream`` call on that
    backend fails, one on ``torch`` would succeed."""
    from repro_torch.serve.guard import GuardPolicy
    from repro_torch.runtime.fault import FaultPolicy

    real_stream = dispatch.edge_stream
    calls = []

    def k3_refused(frames, cfg, state, **kw):
        calls.append(cfg.backend)
        if cfg.backend != "torch":
            raise RuntimeError("K3 launch refused")
        return real_stream(frames, cfg, state, **kw)

    monkeypatch.setattr(dispatch, "resolve_backend", lambda backend, device: "cuda")
    monkeypatch.setattr(dispatch, "edge_stream", k3_refused)
    policy = GuardPolicy(fault=FaultPolicy(max_retries_per_step=2, backoff_s=0.0))
    eng = StreamEngine(EdgeConfig(nms=True, hysteresis=True, block_h=16, block_w=16),
                       max_streams=1, device="cpu", guard=policy)
    assert eng.health.backend == "cuda"
    eng.submit(StreamRequest(sid=0, frames=[video_frame(_small(get_config), 0, 0)]))
    with pytest.raises(RuntimeError, match="K3 launch refused"):
        eng.run()
    assert len(calls) == 3 and "torch" not in calls  # first try and two retries
    assert not eng.health.degraded and eng.health.counts["degraded"] == 0
