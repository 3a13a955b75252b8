"""The port's tuning cache and block choice against repro.kernels.tuning and
repro.kernels.dispatch, and the ring depth through the facade.

Cache files are the reference's schema v6 in both packages: a file written
by either reads in the other with the same lookups, old files migrate to the
same keys, and bad files are skipped with the same warnings.
"""
import json
import threading

import numpy as np
import pytest
import torch

from repro.api import EdgeConfig as RefConfig
from repro.api import edge_detect as ref_edge_detect
from repro.kernels import dispatch as ref_dispatch
from repro.kernels import tuning as ref_tuning
from repro_torch.api import EdgeConfig, edge_detect
from repro_torch.core.filters import get_operator
from repro_torch.kernels import dispatch, tuning
from repro_torch.kernels import edge as ekern

KEY_FIELDS = (
    dict(backend="cuda", dtype="float32", operator="sobel5", variant="v2", h=2048, w=2048),
    dict(backend="torch", dtype="uint8", operator="sobel3", variant="separable", h=37, w=53,
         padding="zero", layout="rgb"),
    dict(backend="cuda", dtype="uint8", operator="sobel7", variant="v1", h=1080, w=1920,
         padding="edge", precision="int", depth=3),
    dict(backend="cuda", dtype="float32", operator="scharr3", variant="separable", h=64,
         w=64, devices=4, mesh="1x2x2", precision="f32", depth=8, plan="canny5:abc123"),
)


@pytest.mark.parametrize("fields", KEY_FIELDS, ids=range(len(KEY_FIELDS)))
def test_tune_key_string_equals_reference(fields):
    assert tuning.TuneKey(**fields).to_str() == ref_tuning.TuneKey(**fields).to_str()
    assert tuning.TuningCache.VERSION == ref_tuning.TuningCache.VERSION == 6


@pytest.mark.parametrize("writer", ("reference", "port"))
def test_cache_files_read_across_packages(tmp_path, writer):
    path = str(tmp_path / "blocks.json")
    w_mod, r_mod = (ref_tuning, tuning) if writer == "reference" else (tuning, ref_tuning)
    cache = w_mod.TuningCache(path)
    for i, fields in enumerate(KEY_FIELDS):
        cache.record(w_mod.TuneKey(**fields), 8 * (i + 1), 32 * (i + 1), 10.0 + i, depth=i)
    cache.save()
    other = r_mod.TuningCache(path)
    assert len(other) == len(KEY_FIELDS)
    for i, fields in enumerate(KEY_FIELDS):
        assert other.lookup(r_mod.TuneKey(**fields)) == (8 * (i + 1), 32 * (i + 1), i)
    assert other.lookup(r_mod.TuneKey(**dict(KEY_FIELDS[0], h=1))) is None
    with open(path) as f:
        assert json.load(f)["__meta__"] == {"version": 6}


# The reference's migration fixtures (tests/test_tuning_dispatch.py): a file
# of each older schema.
MIGRATIONS = {
    "v1": {"__meta__": {"version": 1},
           "pallas-interpret/float32/5x5/v2/64x512": {"block_h": 16, "block_w": 128, "us": 12.5},
           "garbage-key": {"block_h": 1, "block_w": 1, "us": 1.0}},
    "v1-no-meta": {"pallas-tpu/uint8/3x3/separable/1024x2048":
                   {"block_h": 32, "block_w": 256, "us": 3.0}},
    "v2": {"__meta__": {"version": 2},
           "pallas-interpret/float32/5x5/v2/reflect/gray/32x48":
               {"block_h": 16, "block_w": 16, "us": 10.0},
           "pallas-tpu/uint8/3x3/separable/zero/rgb/1024x2048":
               {"block_h": 32, "block_w": 256, "us": 3.0},
           "pallas-tpu/uint8/9x9/separable/zero/rgb/1024x2048":
               {"block_h": 8, "block_w": 128, "us": 9.0}},
    "v3": {"__meta__": {"version": 3},
           "pallas-interpret/float32/scharr3/separable/edge/rgb/720x1280":
               {"block_h": 16, "block_w": 64, "us": 7.0},
           "not/enough/segments": {"block_h": 1, "block_w": 1, "us": 1.0}},
    "v4": {"__meta__": {"version": 4},
           "pallas-interpret/uint8/sobel5/v2/reflect/gray/720x1280/1/1x1x1":
               {"block_h": 16, "block_w": 64, "us": 7.0},
           "pallas-tpu/float32/sobel7/v1/edge/rgb/512x640/4/1x2x2":
               {"block_h": 32, "block_w": 128, "us": 3.0},
           "not/enough/segments": {"block_h": 1, "block_w": 1, "us": 1.0}},
    "v5": {"__meta__": {"version": 5},
           "pallas-interpret/uint8/sobel5/v2/reflect/gray/720x1280/1/1x1x1/int/2":
               {"block_h": 16, "block_w": 64, "depth": 2, "us": 7.0},
           "pallas-tpu/float32/sobel5/v2/reflect/gray/1024x1024/4/1x2x2/f32/0":
               {"block_h": 32, "block_w": 128, "us": 3.0},
           "not/enough/segments": {"block_h": 1, "block_w": 1, "us": 1.0}},
}


@pytest.mark.parametrize("name", sorted(MIGRATIONS))
def test_migrations_give_the_references_keys(tmp_path, name):
    for pkg in ("ref", "port"):
        (tmp_path / pkg).mkdir()
        (tmp_path / pkg / "c.json").write_text(json.dumps(MIGRATIONS[name]))
    ref = ref_tuning.TuningCache(str(tmp_path / "ref" / "c.json"))
    got = tuning.TuningCache(str(tmp_path / "port" / "c.json"))
    assert got._entries == ref._entries and len(got) > 0
    ref.save()
    got.save()
    assert (json.loads((tmp_path / "port" / "c.json").read_text())
            == json.loads((tmp_path / "ref" / "c.json").read_text()))


_CUR_KEY = "cuda/float32/sobel5/v2/reflect/gray/64x64/1/1x1x1/f32/0/-"
BAD_FILES = {
    "corrupt": ("{not json", "unreadable tuning cache", 0),
    "truncated": (json.dumps({"__meta__": {"version": 6},
                              _CUR_KEY: {"block_h": 8, "block_w": 32, "us": 1.0}})[:40],
                  "unreadable tuning cache", 0),
    "future": (json.dumps({"__meta__": {"version": 7},
                           _CUR_KEY: {"block_h": 8, "block_w": 32, "us": 1.0}}),
               "newer than supported", 0),
    "non-object": ("[1, 2, 3]", "expected a JSON object", 0),
    "mixed": (json.dumps({"__meta__": {"version": 6},
                          _CUR_KEY: {"block_h": 8, "block_w": 32, "us": 1.0},
                          _CUR_KEY.replace("64x64", "32x32"): {"block": "8x32"},
                          _CUR_KEY.replace("64x64", "16x16"): {"block_h": "eight",
                                                                "block_w": 32},
                          _CUR_KEY.replace("64x64", "8x8"): [8, 32]}),
              "corrupted tuning cache", 1),
}


@pytest.mark.parametrize("name", sorted(BAD_FILES))
def test_bad_files_skip_and_warn_like_the_reference(tmp_path, name):
    text, match, n = BAD_FILES[name]
    path = tmp_path / "c.json"
    path.write_text(text)
    with pytest.warns(RuntimeWarning, match=match):
        ref = ref_tuning.TuningCache(str(path))
    with pytest.warns(RuntimeWarning, match=match):
        got = tuning.TuningCache(str(path))
    assert len(got) == len(ref) == n
    key = tuning.TuneKey("cuda", "float32", "sobel5", "v2", 64, 64)
    assert got.lookup(key) == ((8, 32, 0) if n else None)
    bh, bw, depth, src = dispatch.choose_block_shape(64, 64, backend="cuda", cache=got)
    assert src == ("tuned" if n else "default") and depth == 0


def _key(i):
    return tuning.TuneKey("cuda", "float32", "sobel5", "v2", 64 + i, 64)


def test_save_merges_concurrent_writers(tmp_path):
    path = str(tmp_path / "blocks.json")
    n = 8
    caches = [tuning.TuningCache(path) for _ in range(n)]
    for i, c in enumerate(caches):
        c.record(_key(i), 8, 32, us=100.0 + i)
    barrier = threading.Barrier(n)

    def writer(c):
        barrier.wait()
        c.save()

    threads = [threading.Thread(target=writer, args=(c,)) for c in caches]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    merged = tuning.TuningCache(path)
    assert len(merged) == n
    assert all(merged.lookup(_key(i)) == (8, 32, 0) for i in range(n))


@pytest.mark.parametrize("fast_first", (True, False))
def test_save_merge_keeps_faster_tuning(tmp_path, fast_first):
    path = str(tmp_path / "blocks.json")
    slow, fast = tuning.TuningCache(path), tuning.TuningCache(path)
    slow.record(_key(0), 16, 64, us=500.0)
    fast.record(_key(0), 8, 32, us=50.0, depth=2)
    for c in ((fast, slow) if fast_first else (slow, fast)):
        c.save()
    assert tuning.TuningCache(path).lookup(_key(0)) == (8, 32, 2)
    assert slow.lookup(_key(0)) == (8, 32, 2) or not fast_first


def test_choose_block_shape_priority_matches_reference(tmp_path):
    """explicit > tuned > default; an explicit depth pins the depth and its
    own key slot; a tuned entry supplies the depth when none is given. The
    same cache file steers both packages the same way (the default tile is
    each package's own rule)."""
    path = str(tmp_path / "c.json")
    ours = tuning.TuningCache(path)

    def both(**kw):
        theirs = ref_tuning.TuningCache(path)
        got = dispatch.choose_block_shape(64, 512, backend="cuda", cache=tuning.TuningCache(path),
                                          **kw)
        want = ref_dispatch.choose_block_shape(64, 512, backend="cuda", cache=theirs, **kw)
        if want[3] == "default":
            assert got[2:] == want[2:]
        else:
            assert got == want
        return got

    assert both()[2:] == (0, "default")
    ours.record(tuning.TuneKey("cuda", "float32", "sobel5", "v2", 64, 512), 16, 32, 1.0,
                depth=2)
    ours.save()
    assert both() == (16, 32, 2, "tuned")
    assert both(block_h=8) == (8, 32, 2, "tuned")
    assert both(pipeline_depth=3)[2:] == (3, "default")
    ours.record(tuning.TuneKey("cuda", "float32", "sobel5", "v2", 64, 512, depth=3), 8, 64,
                1.0, depth=3)
    ours.save()
    assert both(pipeline_depth=3) == (8, 64, 3, "tuned")
    assert both(precision="int")[2:] == (0, "default")
    assert both(block_h=8, block_w=8) == (8, 8, 0, "explicit")
    assert both(block_h=8, block_w=8, pipeline_depth=4) == (8, 8, 4, "explicit")


@pytest.mark.parametrize("depth", (0, 2, 3, 8))
@pytest.mark.parametrize("layout,dtype", (("gray", "uint8"), ("gray", "float32"),
                                          ("rgb", "uint8"), ("rgb", "float32")))
@pytest.mark.parametrize("operator", ("sobel5", "sobel3", "sobel7"))
def test_legal_shapes_fit_their_depth(operator, layout, dtype, depth):
    spec = get_operator(operator)
    shapes = tuning.legal_block_shapes(2048, 2048, operator=operator, backend="cuda",
                                       layout=layout, dtype=dtype, depth=depth)
    assert shapes
    for bh, bw in shapes:
        assert bw % 32 == 0
        # Every kernel the tile may serve fits, with NMS on: K1/K3 and K2
        # at the depth.
        for nms in (False, True):
            if depth:
                smem = ekern.pipelined_smem_bytes(bh, bw, spec.radius, depth,
                                                  np.dtype(dtype).itemsize,
                                                  3 if layout == "rgb" else 1, nms)
                assert smem <= ekern.SMEM_MAX
            assert ekern.window_smem_bytes(bh, bw, spec.radius, nms) <= ekern.SMEM_MAX
    everything = len(tuning._CAND_H) * len(tuning._CAND_W)
    assert len(shapes) < everything  # the largest tiles never fit


def test_legal_shapes_prune_like_the_reference():
    """Past twice the image only the smallest candidate survives, as in
    the reference; the budget is the card's shared memory."""
    got = tuning.legal_block_shapes(20, 40, backend="torch")
    assert {bh for bh, _ in got} <= {8, 16, 32} and {bw for _, bw in got} <= {32, 64}
    assert (8, 32) in got


def test_autotune_on_the_cpu_steers_dispatch(tmp_path):
    cache = tuning.TuningCache(str(tmp_path / "c.json"))
    best = tuning.autotune(64, 96, backend="torch", shapes=[(16, 32), (32, 64)], iters=1,
                           cache=cache, save=False)
    rows = tuning.sweep(64, 96, backend="torch", shapes=[(16, 32), (32, 64)], iters=1,
                        depths=(0, 2))
    assert len(rows) == 4 and {r["depth"] for r in rows} == {0, 2}
    assert best in {(r["block_h"], r["block_w"], r["depth"]) for r in rows}
    assert dispatch.choose_block_shape(64, 96, backend="torch", cache=cache) == best + ("tuned",)
    assert tuning.autotune(64, 96, backend="torch", cache=cache, save=False) == best
    x = np.random.default_rng(4).integers(0, 256, (2, 64, 96)).astype(np.float32)
    tuned = dispatch.edge(x, EdgeConfig(with_max=True).resolved(), layout="NHW",
                          device="cpu", tuning_cache=cache)
    plain = edge_detect(x, EdgeConfig(with_max=True), device="cpu")
    assert torch.equal(tuned.magnitude, plain.magnitude) and torch.equal(tuned.peak, plain.peak)


def test_tuning_defaults_to_the_card(tmp_path, monkeypatch):
    """With no backend named, the tuner times the CUDA kernels, and raises
    where there is no card instead of tuning the plain lane on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cache = tuning.TuningCache(str(tmp_path / "c.json"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tuning.autotune(64, 96, shapes=[(16, 32)], iters=1, cache=cache, save=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tuning.sweep(64, 96, shapes=[(16, 32)], iters=1)
    assert len(cache) == 0
    assert all(bw % 32 == 0 for _, bw in tuning.legal_block_shapes(64, 96))
    for fn in (tuning.autotune, tuning.sweep, tuning.legal_block_shapes):
        with pytest.raises(ValueError, match="unknown tuning backend 'xla'"):
            fn(64, 96, backend="xla")


@pytest.mark.parametrize("dtype,entry", (("float32", (128, 256, 0)), ("float32", (32, 512, 2)),
                                         ("uint8", (64, 256, 8))))
def test_tuned_tile_too_big_for_nms_is_skipped(tmp_path, monkeypatch, dtype, entry):
    """The key carries no ``nms``: a tuned tile that fits the magnitude
    lane but not the NMS footprint serves the magnitude lane and is skipped,
    with a warning, for an NMS call and for the stream path's K3 where K3
    cannot hold it; the tuner never records such a tile."""
    bh, bw, depth = entry
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "c.json"))
    cache = tuning.TuningCache()
    cache.record(tuning.TuneKey("cuda", dtype, "sobel5", "v2", 2048, 2048), bh, bw, 1.0,
                 depth=depth)
    cache.save()
    kw = dict(backend="cuda", dtype=dtype, cache=cache)
    assert dispatch.choose_block_shape(2048, 2048, **kw) == (bh, bw, depth, "tuned")
    with pytest.warns(RuntimeWarning, match="skipping tuned tile"):
        got = dispatch.choose_block_shape(2048, 2048, nms=True, **kw)
    assert got == ekern.default_block_shape(2048, 2048, 5) + (0, "default")
    spec = get_operator("sobel5")
    assert not tuning.tile_fits(bh, bw, spec, depth=depth, dtype=dtype)
    assert (bh, bw) not in tuning.legal_block_shapes(2048, 2048, dtype=dtype, depth=depth)
    # The stream path (K3: depth 0) skips what its footprint cannot hold.
    cfg = EdgeConfig(nms=True, hysteresis=True).resolved()
    k3_fits = ekern.window_smem_bytes(bh, bw, spec.radius, True) <= ekern.SMEM_MAX
    if k3_fits:
        assert dispatch.stream_block_shape(2048, 2048, cfg, backend="cuda",
                                           dtype=dtype) == (bh, bw)
    else:
        with pytest.warns(RuntimeWarning, match="skipping tuned tile"):
            block = dispatch.stream_block_shape(2048, 2048, cfg, backend="cuda", dtype=dtype)
        assert block == ekern.default_block_shape(2048, 2048, 5)


def test_measure_us_positive():
    assert tuning.measure_us(lambda: torch.zeros(4), iters=2) > 0


@pytest.mark.parametrize("depth", (2, 3, 8))
@pytest.mark.parametrize("kind", ("u8", "f32", "rgb"))
def test_depth_equals_depthless_and_reference(kind, depth):
    rng = np.random.default_rng(depth)
    shape = (2, 37, 53) + ((3,) if kind == "rgb" else ())
    x = rng.integers(0, 256, shape).astype(np.float32 if kind == "f32" else np.uint8)
    for extra in (dict(with_max=True), dict(nms=True, hysteresis=True, with_max=True)):
        got = edge_detect(x, EdgeConfig(pipeline_depth=depth, **extra), device="cpu")
        base = edge_detect(x, EdgeConfig(**extra), device="cpu")
        ref = ref_edge_detect(x, RefConfig(backend="xla", pipeline_depth=depth, **extra))
        for field in ("magnitude", "peak") + (("edges",) if extra.get("nms") else ()):
            assert torch.equal(getattr(got, field), getattr(base, field))
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(ref, field)))


@pytest.mark.parametrize("bad", (1, 9, 0, -2, "2", 2.0))
def test_invalid_depths_raise_the_references_message(bad):
    with pytest.raises(ValueError) as want:
        RefConfig(pipeline_depth=bad).resolved()
    with pytest.raises(ValueError) as got:
        edge_detect(np.zeros((8, 8), np.uint8), pipeline_depth=bad, device="cpu")
    assert str(got.value) == str(want.value)


def test_kernel_level_depth_and_budget_checks():
    spec = get_operator("sobel5")
    x = torch.zeros((1, 8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match=r"0 \(automatic\) or 2..8 \(manual DMA ring\), got 1"):
        ekern.edge_plain(x, spec=spec, variant="v2", directions=4, pipeline_depth=1)
    # A 64x256 f32 tile takes a depth-2 ring and no deeper one.
    f32 = torch.zeros((1, 8, 8))
    assert ekern._pipelined_smem(f32, 64, 256, spec, 2, False, False) <= ekern.SMEM_MAX
    with pytest.raises(ValueError, match=r"pipeline_depth=3 with tile 64x256 needs 288128 B"):
        ekern._pipelined_smem(f32, 64, 256, spec, 3, False, False)
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        ekern.edge_pipelined_cuda(x, spec=spec, variant="v2", directions=4)
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        ekern.edge_cuda(x, spec=spec, variant="v2", directions=4, pipeline_depth=2)


def test_footprint_of_the_full_config():
    """sobel-hd FULL (sobel5, v2, 4 directions, 64x256 tiles): u8 frames take
    every depth, f32 frames depth 2 only. A u8 depth-2 CTA holds two ring
    slots of two TMA boxes of 68 rows x 144 B each (the window's 260 B and
    up to 15 of lead), 9,856 B with their 128-byte alignment (the cp.async
    layout, 68 rows of 288 B, is smaller), 68 + 260 row/column offsets, K1's
    68 x 260 window of 4-byte values, two buffers of 16 warp maxima, an
    mbarrier a slot and 128 B of layout. Its threads are two bands of K1's
    256-thread CTA; with NMS one band of 288 (two would pass the 512
    threads K2 aims at)."""
    fits = {(b, d): ekern.pipelined_smem_bytes(64, 256, 2, d, b, 1, False)
            <= ekern.SMEM_MAX for b in (1, 4) for d in range(2, 9)}
    assert all(fits[(1, d)] for d in range(2, 9))
    assert [d for d in range(2, 9) if fits[(4, d)]] == [2]
    assert ekern.pipelined_smem_bytes(64, 256, 2, 2, 1, 1, False) == (
        2 * 2 * 9856 + 4 * 68 + 4 * 260 + 4 * 68 * 260 + 2 * 16 * 4 + 2 * 8 + 128) == 111728
    assert ekern.pipelined_bands(64, 256, False) == [(0, 32), (32, 64)]
    assert ekern.pipelined_bands(64, 256, True) == [(0, 64)]
