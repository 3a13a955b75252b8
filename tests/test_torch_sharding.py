"""The port's halo-sharded edge engine against the reference.

``repro_torch.sharding.halo`` and ``runtime.elastic`` run on a logical mesh
of ``[torch.device("cpu")] * 8``, the counterpart of the reference tests'
8 forced host devices. Sharded ``edge_detect`` must equal, bit for bit, the
port's single-device output and the reference's single-device
``backend="xla"`` output (orientation within 1 ulp of the reference, as in
``test_torch_api.py``). One subprocess with 8 forced host devices holds the
reference's sharded output to the port's.
"""
import os
import subprocess
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import SUBPROCESS_TIMEOUT

from repro.api import EdgeConfig as RefConfig
from repro.api import edge_detect as ref_edge_detect
from repro.core.filters import get_operator as ref_get_operator
from repro.core.filters import resolve_plan as ref_resolve_plan
from repro.runtime import elastic as ref_elastic
from repro.sharding import halo as ref_halo
from repro_torch.api import EdgeConfig, ShardConfig, edge_detect
from repro_torch.core import make_sharded_edge_fn
from repro_torch.core.filters import get_operator, resolve_plan
from repro_torch.kernels import dispatch, tuning
from repro_torch.kernels import edge as ekern
from repro_torch.runtime import chaos, elastic
from repro_torch.sharding import halo

ROOT = Path(__file__).resolve().parents[1]
CPU8 = [torch.device("cpu")] * 8
OPERATORS = ("prewitt3", "scharr3", "sobel3", "sobel5", "sobel7")
PADDINGS = ("reflect", "edge", "zero")
SHARDS = {"data8": ShardConfig(data=8), "2x2x2": ShardConfig(2, 2, 2),
          "1x4x2": ShardConfig(1, 4, 2)}
FIELDS = ("magnitude", "components", "orientation", "peak", "thin", "edges")


def _inputs():
    """Gray u8/f32 and RGB u8 at the reference test's ragged (3, 67, 45)."""
    rng = np.random.default_rng(20)
    return {
        "u8": rng.integers(0, 256, (3, 67, 45)).astype(np.uint8),
        "f32": np.clip(rng.uniform(0, 255, (3, 67, 45)) + rng.normal(0, 2, (3, 67, 45)),
                       0, 255).astype(np.float32),
        "rgb_u8": rng.integers(0, 256, (3, 67, 45, 3)).astype(np.uint8),
    }


INPUTS = _inputs()


def _assert_same(out, single, ref, what):
    for f in FIELDS:
        a, s, r = getattr(out, f), getattr(single, f), getattr(ref, f)
        assert (a is None) == (s is None) == (r is None), (what, f)
        if a is None:
            continue
        assert torch.equal(a, s), (what, f, "sharded vs single-device")
        a, r = a.numpy(), np.asarray(r)
        assert a.shape == r.shape and a.dtype == r.dtype, (what, f)
        if f == "orientation":
            np.testing.assert_array_max_ulp(a, r, maxulp=1)
        else:
            np.testing.assert_array_equal(a, r, err_msg=str((what, f)))


def _check_sharded(x, cfg, ref_cfg, what):
    single = edge_detect(x, cfg, device="cpu")
    ref = ref_edge_detect(x, ref_cfg)
    for name, shard in SHARDS.items():
        mesh = halo.mesh_from_config(shard, CPU8)
        out = edge_detect(x, cfg.replace(shard=shard), mesh=mesh)
        _assert_same(out, single, ref, (what, name))


# ---------------------------------------------------------------------------
# Geometry, config and planning units
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("radius", (1, 2, 3, 5))
def test_shard_geometry(radius):
    assert halo.shard_geometry(64, 1, radius) == (64, 64)      # unsharded: identity
    sh, hp = halo.shard_geometry(67, 2, radius)                # ragged split
    assert sh * 2 == hp and hp >= 67 + radius                  # radius of slack
    sh, hp = halo.shard_geometry(64, 4, radius)                # divisible still pads
    assert hp >= 64 + radius and hp % 4 == 0
    for n in (1, 5, 33, 67, 2048):
        for parts in (1, 2, 3, 4, 8):
            assert halo.shard_geometry(n, parts, radius) == ref_halo.shard_geometry(
                n, parts, radius)


def test_shard_config_parse_and_resolve():
    assert ShardConfig.parse("2x2x2") == ShardConfig(data=2, rows=2, cols=2)
    assert ShardConfig.parse("auto") == ShardConfig.auto()
    assert ShardConfig.parse("0x4x2").resolve(8) == (1, 4, 2)
    assert ShardConfig(data=0).resolve(8) == (8, 1, 1)  # auto-fill data
    for text in ("2x2x2", "auto", "", "0x4x2", "1x2x4", "8x1x1", " 2X1x1 "):
        ref = ref_halo.ShardConfig.parse(text)
        port = ShardConfig.parse(text)
        assert (port.data, port.rows, port.cols) == (ref.data, ref.rows, ref.cols)
        for n in (1, 2, 4, 7, 8, 16):
            try:
                want = ref.resolve(n)
            except ValueError as err:
                with pytest.raises(ValueError) as got:
                    port.resolve(n)
                assert str(got.value) == str(err)
            else:
                assert port.resolve(n) == want


@pytest.mark.parametrize("bad,n", (
    ("parse:2x2", 8),
    ("1x4x4", 8),       # spatial > devices
    ("4x2x2", 8),       # explicit total > devices
    ("2x0x2", 8),       # zero spatial degree
    ("2x2x2", 1),       # the server's one-device startup check
), ids=lambda v: str(v))
def test_shard_config_errors_use_the_reference_words(bad, n):
    if bad.startswith("parse:"):
        with pytest.raises(ValueError) as ref_err:
            ref_halo.ShardConfig.parse(bad[6:])
        with pytest.raises(ValueError) as err:
            ShardConfig.parse(bad[6:])
    else:
        d, r, c = (int(v) for v in bad.split("x"))
        with pytest.raises(ValueError) as ref_err:
            ref_halo.ShardConfig(d, r, c).resolve(n)
        with pytest.raises(ValueError) as err:
            ShardConfig(d, r, c).resolve(n)
    assert str(err.value) == str(ref_err.value)


def test_plan_image_mesh_shrinks_data_first():
    shape, axes = elastic.plan_image_mesh(8, rows=2, cols=2)
    assert shape == (2, 2, 2) and axes == ("data", "row", "col")
    assert elastic.plan_image_mesh(4, rows=2, cols=2)[0] == (1, 2, 2)
    assert elastic.plan_image_mesh(2, rows=2, cols=2)[0] == (1, 1, 2)
    assert elastic.plan_image_mesh(1, rows=2, cols=2)[0] == (1, 1, 1)
    for n in range(1, 17):
        for rows, cols in ((1, 1), (2, 2), (4, 2), (1, 8), (3, 1)):
            for data in (0, 1, 2, 4):
                assert elastic.plan_image_mesh(n, rows=rows, cols=cols, data=data) == \
                    ref_elastic.plan_image_mesh(n, rows=rows, cols=cols, data=data)
        for mp in (1, 2, 4, 8):
            for pods in (1, 2):
                assert elastic.plan_mesh(n, model_parallel=mp, pods=pods) == \
                    ref_elastic.plan_mesh(n, model_parallel=mp, pods=pods)


def test_make_image_mesh(monkeypatch):
    devs = [torch.device("cpu", i) for i in range(8)]
    mesh = elastic.make_image_mesh(devs, rows=2, cols=2)
    assert mesh.shape == {"data": 2, "row": 2, "col": 2} and mesh.size == 8
    assert mesh.axis_names == elastic.IMAGE_MESH_AXES == ("data", "row", "col")
    assert mesh.flat() == devs and mesh.lead == devs[0]
    assert mesh.devices[1][0][1] == devs[5]           # [data][row][col], row-major
    small = elastic.make_image_mesh(devs[:3], rows=2, cols=2)
    assert small.shape == {"data": 1, "row": 1, "col": 2} and small.flat() == devs[:2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        elastic.make_image_mesh(rows=2)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        halo.mesh_from_config(ShardConfig(2, 2, 2))


def test_single_device_shard_config_is_identity():
    x = np.random.default_rng(0).integers(0, 256, (2, 33, 41)).astype(np.float32)
    ref = edge_detect(x, EdgeConfig(), device="cpu")
    out = edge_detect(x, EdgeConfig(shard=ShardConfig(data=1)), device="cpu")
    assert torch.equal(out.magnitude, ref.magnitude)
    mesh = elastic.make_image_mesh(CPU8[:1])
    assert torch.equal(edge_detect(x, mesh=mesh).magnitude, ref.magnitude)


@pytest.mark.parametrize("op", OPERATORS)
def test_exchange_radius(op):
    for nms in (False, True):
        assert halo.exchange_radius(get_operator(op), nms) == \
            ref_halo.exchange_radius(ref_get_operator(op), nms)
        assert halo.exchange_radius(get_operator(op), nms) == get_operator(op).radius + nms


def test_exchange_radius_of_plans():
    for name in ("canny5", "blur_sobel5"):
        plan, ref_plan = resolve_plan(name), ref_resolve_plan(name)
        for nms in (False, True):
            got = halo.exchange_radius(plan.gradient, nms, plan=plan)
            assert got == ref_halo.exchange_radius(ref_plan.gradient, nms, plan=ref_plan)
    # canny5: Gaussian 5x5 then Sobel 5x5 (reach 4) and its NMS ring.
    assert halo.exchange_radius(None, False, plan=resolve_plan("canny5")) == 5


@pytest.mark.parametrize("padding", PADDINGS)
def test_extend_axis_matches_reference(padding):
    rng = np.random.default_rng(3)
    for shape, axis, n, total in (((2, 7, 5), 1, 7, 12), ((2, 7, 5), 2, 5, 9),
                                  ((1, 3, 4, 3), 1, 3, 10), ((2, 1, 6), 1, 1, 4),
                                  ((2, 9, 9), 2, 9, 9)):
        for dtype in (np.uint8, np.float32):
            a = rng.integers(0, 256, shape).astype(dtype)
            got = halo.extend_axis(torch.from_numpy(a), axis, n, total, padding)
            want = np.asarray(ref_halo.extend_axis(jnp.asarray(a), axis, n, total, padding))
            assert got.numpy().dtype == want.dtype
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("axis", (1, 2))
def test_halo_exchange_on_a_four_band_grid(padding, axis):
    """Four bands along one axis: interior halos are the neighbours' rows,
    the first band's leading halo is the boundary rule's extension (zeros
    under ``zero``), the last band's trailing halo is zero."""
    r, sh, n = 2, 6, 21                 # n_global < 4 * sh: the last band is ragged
    rng = np.random.default_rng(5)
    shape = [2, 4 * sh, 4 * sh]
    g = rng.integers(1, 256, shape).astype(np.float32)
    blocks = [torch.from_numpy(np.take(g, range(k * sh, (k + 1) * sh), axis=axis))
              for k in range(4)]
    out = halo.halo_exchange(blocks, r, padding, axis=axis, n_global=n)
    # Oracle: the whole line with the global leading extension and a zero tail.
    mode = {"reflect": "reflect", "edge": "edge", "zero": "constant"}[padding]
    width = [(0, 0)] * 3
    width[axis] = (r, 0)
    lead = np.pad(g, width, mode=mode)
    tail_shape = list(shape)
    tail_shape[axis] = r
    line = np.concatenate([lead, np.zeros(tail_shape, np.float32)], axis=axis)
    for k, b in enumerate(out):
        want = np.take(line, range(k * sh, k * sh + sh + 2 * r), axis=axis)
        np.testing.assert_array_equal(b.numpy(), want, err_msg=f"band {k}")
    assert halo.halo_exchange(blocks[:1], r, padding, axis=axis, n_global=n)[0] is blocks[0]
    with pytest.raises(ValueError, match="unknown padding"):
        halo.halo_exchange(blocks, r, "wrap", axis=axis, n_global=n)


def test_halo_exchange_keeps_the_dtype():
    blocks = [torch.full((1, 4, 5), k, dtype=torch.uint8) for k in range(3)]
    out = halo.halo_exchange(blocks, 1, "reflect", axis=1, n_global=12)
    assert all(b.dtype == torch.uint8 and b.shape == (1, 6, 5) for b in out)
    assert out[1][0, 0, 0] == 0 and out[1][0, -1, 0] == 2


# ---------------------------------------------------------------------------
# Bit-exact sharded output, in-process on [cpu] * 8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("op", OPERATORS)
def test_sharded_equals_single_device_and_reference(op, padding):
    kw = dict(operator=op, padding=padding, with_components=True, with_orientation=True,
              with_max=True)
    for kind, x in INPUTS.items():
        _check_sharded(x, EdgeConfig(**kw), RefConfig(backend="xla", **kw), (op, padding, kind))


@pytest.mark.parametrize("padding", PADDINGS)
def test_sharded_nms_hysteresis(padding):
    kw = dict(padding=padding, nms=True, hysteresis=True, with_max=True)
    for kind, x in INPUTS.items():
        _check_sharded(x, EdgeConfig(**kw), RefConfig(backend="xla", **kw), (padding, kind))


@pytest.mark.parametrize("op", OPERATORS)
def test_sharded_integer_lane(op):
    """u8 gray on the exact integer lane, per shard, equals the reference's
    integer lane and the f32 lane."""
    x = INPUTS["u8"]
    for nms in (False, True):
        kw = dict(operator=op, precision="int", with_max=True, nms=nms)
        _check_sharded(x, EdgeConfig(**kw), RefConfig(backend="xla", **kw), (op, nms))


@pytest.mark.parametrize("padding", PADDINGS)
def test_sharded_canny5(padding):
    """A stencil plan exchanges its composed reach plus the NMS ring (5 rows
    for canny5) and equals the fused single-device chain."""
    kw = dict(plan="canny5", padding=padding, hysteresis=True, with_max=True)
    for kind, x in INPUTS.items():
        _check_sharded(x, EdgeConfig(**kw), RefConfig(backend="xla", **kw), (padding, kind))


def test_sharded_normalized_default_config():
    for kind, x in INPUTS.items():
        _check_sharded(x, EdgeConfig(), RefConfig(backend="xla"), kind)
        _check_sharded(x, EdgeConfig(normalize=False), RefConfig(backend="xla", normalize=False),
                       kind)


def test_sharded_batch_layouts():
    """A 2-D frame and an NTHW stack keep their batch dims through a mesh."""
    x = INPUTS["u8"]
    mesh = halo.mesh_from_config(ShardConfig(2, 2, 2), CPU8)
    for frames in (x[0], x.reshape(1, 3, 67, 45)):
        out = edge_detect(frames, EdgeConfig(with_max=True), mesh=mesh)
        ref = ref_edge_detect(frames, RefConfig(backend="xla", with_max=True))
        assert out.layout == ref.layout
        np.testing.assert_array_equal(out.magnitude.numpy(), np.asarray(ref.magnitude))
        np.testing.assert_array_equal(out.peak.numpy(), np.asarray(ref.peak))


def test_too_small_for_operator_radius_raises_the_reference_error():
    x = np.zeros((1, 6, 45), np.float32)
    shape = {"data": 1, "row": 4, "col": 1}
    with pytest.raises(ValueError) as ref_err:
        ref_halo.sharded_edge(jnp.asarray(x), types.SimpleNamespace(shape=shape), radius=3,
                              padding="reflect", compute=None)
    with pytest.raises(ValueError, match="too small for operator radius 3") as err:
        edge_detect(x, EdgeConfig(nms=True), mesh=elastic.make_image_mesh(CPU8, rows=4))
    assert str(err.value) == str(ref_err.value)


def test_one_engine_launch_per_shard(monkeypatch):
    calls = []
    real = ekern.edge_plain

    def counting(x, **kw):
        calls.append(tuple(x.shape))
        return real(x, **kw)

    monkeypatch.setattr(ekern, "edge_plain", counting)
    x = INPUTS["f32"]
    # 2x2x2: 67 rows -> 2 bands of ceil(69 / 2) = 35 rows + 2 * 2 halo rows,
    # 45 columns -> 2 bands of ceil(47 / 2) = 24 + 4; 1x4x2: ceil(69 / 4) + 4.
    for name, shard, want in (("data8", ShardConfig(data=8), [(1, 67, 45)] * 8),
                              ("2x2x2", ShardConfig(2, 2, 2), [(2, 39, 28)] * 8),
                              ("1x4x2", ShardConfig(1, 4, 2), [(3, 22, 28)] * 8)):
        calls.clear()
        edge_detect(x, EdgeConfig(with_max=True), mesh=halo.mesh_from_config(shard, CPU8))
        assert calls == want, name


def test_sharded_tile_comes_from_the_mesh_slot(monkeypatch, tmp_path):
    """The tuning key of a sharded call carries the mesh; with no entry the
    default tile is sized for the halo-extended block."""
    seen = []
    real = ekern.edge_plain

    def spy(x, **kw):
        seen.append((kw["block_h"], kw["block_w"]))
        return real(x, **kw)

    monkeypatch.setattr(ekern, "edge_plain", spy)
    cache = tuning.TuningCache(str(tmp_path / "blocks.json"))
    key = tuning.TuneKey("torch", "float32", "sobel5", "v2", 67, 45, devices=8, mesh="2x2x2")
    cache.record(key, 16, 32, 1.0)
    x = INPUTS["f32"]
    mesh = halo.mesh_from_config(ShardConfig(2, 2, 2), CPU8)
    dispatch.edge(x, EdgeConfig(with_max=True), mesh=mesh, tuning_cache=cache)
    assert set(seen) == {(16, 32)}
    bh, bw, _d, src = dispatch.choose_block_shape(
        67, 45, backend="torch", cache=tuning.TuningCache(str(tmp_path / "empty.json")), devices=8,
        mesh="2x2x2", kernel_h=39, kernel_w=28)
    assert (bh, bw, src) == (*ekern.default_block_shape(39, 28, 5), "default")


def test_chaos_sites_fire():
    x = INPUTS["f32"]
    mesh = halo.mesh_from_config(ShardConfig(2, 2, 2), CPU8)
    for site in ("dispatch.edge", "halo.sharded_edge"):
        plan = chaos.FaultPlan([chaos.StepFail(site=site, step=0)])
        with pytest.raises(chaos.InjectedFault, match=site):
            dispatch.edge(x, EdgeConfig(), mesh=mesh, chaos=plan)
        out = dispatch.edge(x, EdgeConfig(), mesh=mesh, chaos=plan)   # healed
        assert out.magnitude.shape == (3, 67, 45)


def test_mesh_and_device_types_must_agree():
    mesh = halo.mesh_from_config(ShardConfig(2, 2, 2), CPU8)
    with pytest.raises(ValueError, match="mix device types"):
        edge_detect(INPUTS["f32"], mesh=mesh, device="cuda")


def test_stream_path_refuses_shard_in_the_reference_words():
    from repro.kernels import dispatch as ref_dispatch

    with pytest.raises(ValueError) as ref_err:
        ref_dispatch._check_stream_config(RefConfig(shard=ref_halo.ShardConfig(2, 1, 1)))
    with pytest.raises(ValueError) as err:
        dispatch._check_stream_config(EdgeConfig(shard=ShardConfig(2, 1, 1)))
    assert str(err.value) == str(ref_err.value)


@pytest.mark.parametrize("kind", ("u8", "rgb_u8"))
def test_make_sharded_edge_fn_matches_reference(kind):
    import jax
    from jax.sharding import Mesh

    from repro.core.pipeline import make_sharded_edge_fn as ref_make

    x = INPUTS[kind]
    ref_mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    want = np.asarray(ref_make(ref_mesh, size=3)(jnp.asarray(x)))
    mesh = elastic.make_image_mesh(CPU8, rows=4, cols=2)           # (1, 4, 2)
    for mesh_, kw in ((mesh, {}), (elastic.make_image_mesh(CPU8, rows=2), {}),
                      (mesh, dict(batch_axes=()))):
        got = make_sharded_edge_fn(mesh_, size=3, **kw)(x)
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# The reference's sharded engine on 8 forced host devices
# ---------------------------------------------------------------------------

REF_SHARDED = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax, jax.numpy as jnp, torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.api import EdgeConfig as RefConfig, ShardConfig as RefShard, edge_detect as ref_ed
from repro.sharding import halo as ref_halo
from repro_torch.api import EdgeConfig, ShardConfig, edge_detect
from repro_torch.sharding import halo

assert len(jax.devices()) == 8
cpu8 = [torch.device("cpu")] * 8
rng = np.random.default_rng(7)
gray = rng.integers(0, 256, (3, 67, 45)).astype(np.float32)
u8 = rng.integers(0, 256, (3, 67, 45)).astype(np.uint8)
rgb = rng.integers(0, 256, (3, 67, 45, 3)).astype(np.uint8)
cases = [
    (gray, dict(operator="scharr3", with_max=True, with_components=True), (8, 1, 1)),
    (gray, dict(operator="sobel5", padding="edge", with_max=True), (2, 2, 2)),
    (u8, dict(operator="sobel7", padding="zero", with_max=True), (1, 4, 2)),
    (rgb, dict(operator="sobel5", with_max=True), (2, 2, 2)),
    (gray, dict(nms=True, hysteresis=True, with_max=True), (2, 2, 2)),
    (u8, dict(precision="int", nms=True, with_max=True), (1, 4, 2)),
    (u8, dict(plan="canny5", hysteresis=True, with_max=True), (2, 2, 2)),
]
for x, kw, (d, r, c) in cases:
    cfg = RefConfig(backend="xla", shard=RefShard(d, r, c), **kw)
    ref = jax.jit(lambda a: ref_ed(a, cfg))(x)    # eager shard_map compiles op by op
    out = edge_detect(x, EdgeConfig(shard=ShardConfig(d, r, c), **kw),
                      mesh=halo.mesh_from_config(ShardConfig(d, r, c), cpu8))
    for f in ("magnitude", "components", "peak", "thin", "edges"):
        a, b = getattr(out, f), getattr(ref, f)
        assert (a is None) == (b is None), (kw, f)
        if a is not None:
            assert np.array_equal(a.numpy(), np.asarray(b)), (kw, (d, r, c), f)
print("SHARDED_OK")

# The halo exchange itself on a 1x4 row mesh, every padding.
mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("row",))
g = rng.integers(0, 256, (2, 24, 5)).astype(np.float32)
for padding in ("reflect", "edge", "zero"):
    fn = shard_map(lambda xl: ref_halo.halo_exchange(xl, 2, padding, axis=1, axis_name="row",
                                                    parts=4, n_global=21),
                   mesh=mesh, in_specs=(P(None, "row"),), out_specs=P(None, "row"),
                   check_rep=False)
    want = np.asarray(jax.jit(fn)(jnp.asarray(g)))
    blocks = [torch.from_numpy(g[:, k * 6:(k + 1) * 6]) for k in range(4)]
    got = torch.cat(halo.halo_exchange(blocks, 2, padding, axis=1, n_global=21), dim=1)
    assert np.array_equal(got.numpy(), want), padding
print("HALO_OK")
"""


def test_reference_sharded_output_on_8_devices_equals_the_port():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", REF_SHARDED], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=SUBPROCESS_TIMEOUT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "SHARDED_OK" in out.stdout and "HALO_OK" in out.stdout
