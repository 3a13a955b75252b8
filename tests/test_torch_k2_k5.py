"""K2's and K5's host-side rules, on the CPU.

K2 (``csrc/edge_pipelined.cu``) sizes its shared memory, splits its
consumer threads into bands and schedules its tiles on a persistent grid;
``kernels/edge.py`` mirrors each rule (``pipelined_smem_bytes``,
``pipelined_bands``, ``pipelined_tiles``) and decides the copy route
(``tma_route``). K5 (``csrc/selective_scan.cu``) reduces y over a
channel's states held in groups, in the order of the first version's xor
butterfly. The kernels need a card (``tests/test_torch_gpu.py``,
``chip_smoke.py``); here the mirrors are held to the sources' constants,
the schedule and bands to their coverage, the reduction order to the
butterfly's bits, and the wrappers' arguments to the C entry points
through a stand-in library.
"""
import contextlib
import ctypes
import itertools
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.filters import SobelParams, get_operator
from repro_torch.kernels import edge as ekern
from repro_torch.kernels import selective_scan as k5

CSRC = Path(ekern.__file__).resolve().parent / "csrc"


def _defines(name: str) -> dict:
    """``#define NAME value`` and ``constexpr int NAME = value`` integers of a source."""
    text = (CSRC / name).read_text()
    out = {m.group(1): int(m.group(2)) for m in re.finditer(r"#define (\w+) (\d+)\b", text)}
    out.update({m.group(1): int(m.group(2))
                for m in re.finditer(r"constexpr int (\w+) = (\d+)", text)})
    return out


def test_k2_constants_match_the_source():
    got = _defines("edge_pipelined.cu")
    assert got["SMEM_MAX"] == ekern.SMEM_MAX == 232448
    assert got["K2_CONSUMERS"] == ekern.K2_CONSUMERS
    assert got["K2_CONSUMERS_WIDE"] == ekern.K2_CONSUMERS_WIDE
    assert got["K2_MAX_THREADS"] == ekern.K2_MAX_THREADS
    assert _defines("edge_tile.cuh")["MAX_THREADS"] == 384
    # K2_CONSUMERS, or one band of K1's largest CTA.
    assert ekern.K2_MAX_THREADS == max(ekern.K2_CONSUMERS, ekern.K2_CONSUMERS_WIDE, 384)


def _boxes(eh, ew, in_bytes):
    """The TMA route's boxes of a gray window (csrc/edge_pipelined.cu,
    pipelined_layout): ``(chunks, box_w, row_boxes, box_h)``."""
    m = 16 // in_bytes
    units = ew + m - 1                     # the window and up to 15 bytes of lead
    chunks = -(-units // (256 // m * m))
    box_w = -(-(-(-units // chunks)) // m) * m
    row_boxes = -(-eh // 256)
    return chunks, box_w, row_boxes, -(-eh // row_boxes)


@pytest.mark.parametrize("in_bytes,channels", ((1, 1), (4, 1), (1, 3), (4, 3)))
@pytest.mark.parametrize("nms", (False, True))
def test_k2_footprint_formula(in_bytes, channels, nms):
    """A cp.async slot row holds a window row behind any lead of 0..15
    bytes, in 16-byte words; a gray slot also holds the TMA boxes (at most
    256 elements a side, a box row of whole 16-byte units, a box from any
    16-byte boundary left of the window covering it); the total is the
    ring, the offsets, K1's window, the barriers and the layout."""
    for (bh, bw), radius, depth in itertools.product(
            ((1, 1), (8, 32), (29, 96), (64, 256), (128, 128), (300, 512)), (1, 2, 4),
            ekern.PIPELINE_DEPTHS):
        r_in = radius + int(nms)
        eh, ew = bh + 2 * r_in, bw + 2 * r_in
        row = -(-(ew * channels * in_bytes + 15) // 16) * 16
        for lead in range(16):   # the last 16-byte word of a row stays in the slot row
            assert -(-(lead + ew * channels * in_bytes) // 16) * 16 <= row
        slot = eh * row
        if channels == 1:
            chunks, box_w, row_boxes, box_h = _boxes(eh, ew, in_bytes)
            assert box_w <= 256 and box_h <= 256 and (box_w * in_bytes) % 16 == 0
            # the window behind a lead of up to 16 // in_bytes - 1 elements
            assert chunks * box_w >= ew + 16 // in_bytes - 1 and row_boxes * box_h >= eh
            slot = max(slot, chunks * row_boxes * (-(-(box_h * box_w * in_bytes) // 128) * 128))
        want = depth * (-(-slot // 128) * 128) + 4 * eh
        want = -(-want // 16) * 16 + 4 * ew
        want = -(-want // 16) * 16 + 4 * eh * ew
        want = -(-want // 16) * 16 + 2 * (ekern.K2_MAX_THREADS // 32) * 4 + depth * 8
        want = -(-want // 16) * 16 + 128
        got = ekern.pipelined_smem_bytes(bh, bw, radius, depth, in_bytes, channels, nms)
        assert got == want, (bh, bw, radius, depth)


@pytest.mark.parametrize("n_tiles,ctas", ((1, 132), (7, 3), (1024, 132), (133, 132),
                                          (5, 5), (4 * 32 * 8, 264)))
def test_k2_schedule_covers_every_tile_once(n_tiles, ctas):
    """The persistent grid's CTAs (at most one per tile) take every tile of
    the batch exactly once, each CTA its tiles in increasing raster order."""
    ctas = min(ctas, n_tiles)
    sched = ekern.pipelined_tiles(n_tiles, ctas)
    assert len(sched) == ctas and all(sched)
    flat = sorted(itertools.chain.from_iterable(sched))
    assert flat == list(range(n_tiles))
    for b, tiles in enumerate(sched):
        assert tiles[0] == b and all(t2 - t1 == ctas for t1, t2 in zip(tiles, tiles[1:]))
    loads = [len(t) for t in sched]
    assert max(loads) - min(loads) <= 1


@pytest.mark.parametrize("size", (3, 5, 7, 9))
@pytest.mark.parametrize("nms", (False, True))
def test_k2_bands_cover_every_row_once(nms, size):
    consumers = ekern.K2_CONSUMERS if size <= 5 else ekern.K2_CONSUMERS_WIDE
    for bh, bw in itertools.product((1, 8, 15, 16, 32, 33, 64, 100, 128, 256, 305),
                                    (32, 64, 96, 128, 256, 384, 1000)):
        bands = ekern.pipelined_bands(bh, bw, nms, size)
        rows = [r for lo, hi in bands for r in range(lo, hi)]
        assert rows == list(range(bh)), (bh, bw, bands)
        tt = ekern._tile_threads(bw, nms)
        assert len(bands) == 1 or (len(bands) * tt <= consumers and len(bands) <= bh // 16)
        assert len(bands) * tt <= (consumers if len(bands) > 1 else 384)


def test_tma_route_follows_alignment():
    x = torch.zeros((2, 8, 96), dtype=torch.uint8)
    assert x.data_ptr() % 16 == 0
    assert ekern.tma_route(x, 96, False)
    assert not ekern.tma_route(x[:, :, :90].contiguous(), 90, False)   # a 90-byte row
    shifted = torch.zeros(2 * 8 * 96 + 1, dtype=torch.uint8)[1:].view(2, 8, 96)
    assert not ekern.tma_route(shifted, 96, False)                       # base off 16 B
    f = torch.zeros((1, 4, 4, 3))
    assert not ekern.tma_route(f, 4, True)          # RGB: boxes would split pixels
    g = torch.zeros((1, 4, 8))
    assert ekern.tma_route(g, 8, False) == (g.data_ptr() % 16 == 0)     # 32-byte rows


class _FakeLib:
    """Records the arguments of the C entry points; every launch succeeds,
    and the scan reports the copy route ``route``."""

    def __init__(self, route=1):
        self.calls, self.route = [], route

    def repro_pipelined_launch(self, *args):
        self.calls.append(("pipelined", args))
        return 0

    def repro_selective_scan_launch(self, *args):
        self.calls.append(("scan", args))
        args[-2]._obj.value = self.route
        return 0


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(ekern, "_lib", lambda name: lib)
    monkeypatch.setattr(k5, "_lib", lambda: lib)
    monkeypatch.setattr(ekern, "_check_launch", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    return lib


# repro_pipelined_launch: the geometry (x, in_u8, rgb, n, h, w, bh, bw, size,
# variant, dirs, padding, nms, tan_pi8, taps), then const_taps, acc_int,
# depth, tma, the four outputs and the stream.
_CONST_ARG = 15


@pytest.mark.parametrize("case", [
    ("sobel5", None, 4, "auto", 1), ("sobel5", None, 2, "auto", 1),
    ("sobel5", None, 4, "runtime", 0), ("sobel5", SobelParams(b=3.0), 4, "auto", 0),
    ("sobel7", None, 4, "auto", 0),
], ids=lambda c: f"{c[0]}-{c[2]}-{c[3]}-{'custom' if c[1] else 'default'}")
@pytest.mark.parametrize("lane", ("f32", "int", "nms"))
@pytest.mark.parametrize("width,offset,tma", ((96, 0, 1), (90, 0, 0), (96, 1, 0)))
def test_edge_pipelined_cuda_passes_instance_lane_depth_and_route(fake_lib, case, lane, width,
                                                                  offset, tma):
    op, params, directions, instance, const = case
    spec = get_operator(op, params)
    flat = torch.zeros(offset + 40 * width, dtype=torch.uint8)
    x = flat[offset:].view(1, 40, width)
    before = {k: getattr(ekern.edge_pipelined_cuda, k) for k in (
        "launches", "int_launches", "const_launches", "tma_launches", "cp_async_launches")}
    out = ekern.edge_cuda(x, spec=spec, variant="v2", directions=directions, block_h=16,
                          block_w=32, instance=instance, pipeline_depth=5,
                          precision="int" if lane == "int" else "f32", out_nms=lane == "nms",
                          with_max=True)
    assert isinstance(out, tuple) and out[1].shape == (1, 3, -(-width // 32))
    (name, args), = fake_lib.calls
    assert name == "pipelined"
    assert args[_CONST_ARG:_CONST_ARG + 4] == (const, int(lane == "int"), 5, tma)
    after = {k: getattr(ekern.edge_pipelined_cuda, k) for k in before}
    assert after == {"launches": before["launches"] + 1,
                     "int_launches": before["int_launches"] + int(lane == "int"),
                     "const_launches": before["const_launches"] + const,
                     "tma_launches": before["tma_launches"] + tma,
                     "cp_async_launches": before["cp_async_launches"] + 1 - tma}


def test_edge_pipelined_cuda_refuses_an_unknown_instance_and_a_big_ring(fake_lib):
    x = torch.zeros((1, 8, 8))
    kw = dict(spec=get_operator("sobel5"), variant="v2", directions=4)
    with pytest.raises(ValueError, match="instance"):
        ekern.edge_pipelined_cuda(x, instance="constant", **kw)
    with pytest.raises(ValueError, match=r"pipeline_depth=3 with tile 64x256 needs 288128 B"):
        ekern.edge_pipelined_cuda(x, block_h=64, block_w=256, pipeline_depth=3, **kw)
    assert not fake_lib.calls


@pytest.mark.parametrize("route", (0, 1))
def test_selective_scan_passes_a_route_slot_and_counts_it(fake_lib, monkeypatch, route):
    fake_lib.route = route
    monkeypatch.setattr(k5, "resolve_backend", lambda backend, device: "cuda")
    x = torch.zeros((1, 8, 64))
    args = (x, x, torch.zeros((1, 8, 33)), torch.zeros((1, 8, 33)), torch.zeros((64, 33)))
    before = (k5.selective_scan.launches, k5.selective_scan.async_launches)
    y, h = k5.selective_scan(*args)
    (name, cargs), = fake_lib.calls
    # (B, L, d_inner, N, bf16 inputs, bf16 elements, the bf16 mode's chunk)
    assert name == "scan" and cargs[7:14] == (1, 8, 64, 33, 0, 0, 8)
    assert isinstance(cargs[14], type(ctypes.byref(ctypes.c_int())))
    assert y.shape == x.shape and h.shape == (1, 64, 33)
    assert (k5.selective_scan.launches, k5.selective_scan.async_launches) == (
        before[0] + 1, before[1] + route)


def test_selective_scan_passes_the_bf16_element_mode(fake_lib, monkeypatch):
    monkeypatch.setattr(k5, "resolve_backend", lambda backend, device: "cuda")
    x = torch.zeros((1, 32, 64))
    args = (x, x, torch.zeros((1, 32, 16)), torch.zeros((1, 32, 16)), torch.zeros((64, 16)))
    before = (k5.selective_scan.launches, k5.selective_scan.bf16_launches)
    k5.selective_scan(*args, chunk=16, block_d=64, scan_dtype="bfloat16")
    k5.selective_scan(*args, chunk=16, block_d=64)
    (_, bf16), (_, f32) = fake_lib.calls
    assert bf16[7:14] == (1, 32, 64, 16, 0, 1, 16) and f32[7:14] == (1, 32, 64, 16, 0, 0, 16)
    assert (k5.selective_scan.launches, k5.selective_scan.bf16_launches) == (
        before[0] + 2, before[1] + 1)


def test_k5_limits_match_the_source():
    got = _defines("selective_scan.cu")
    assert got["NMAX"] == k5.NMAX == 1024
    assert got["K5_GROUP"] >= 1 and got["K5_CHUNK"] >= 1


def _butterfly(p: np.ndarray) -> np.float32:
    """The first version's y: NP lanes, p += shfl_xor(p, off) for off =
    NP/2 .. 1, lane 0's value (f32 adds)."""
    p = p.astype(np.float32).copy()
    off = len(p) // 2
    while off:
        p = (p + p[np.arange(len(p)) ^ off]).astype(np.float32)
        off //= 2
    return p[0]


def _grouped(p: np.ndarray, group: int) -> np.float32:
    """The redesign's y: thread j of TPC = NP / G holds states j + i * TPC;
    its G values are summed by local xor offsets G/2 .. 1, then the TPC
    threads' sums by shuffles at offsets TPC/2 .. 1."""
    np_ = len(p)
    tpc = np_ // group
    part = []
    for j in range(tpc):
        q = [np.float32(p[j + i * tpc]) for i in range(group)]
        off = group // 2
        while off:
            q = [np.float32(q[i] + q[i + off]) for i in range(off)]
            off //= 2
        part.append(q[0])
    return _butterfly(np.asarray(part, np.float32)) if tpc > 1 else part[0]


def _group_of(np_: int, k5_group: int) -> int:
    """csrc/selective_scan.cu's group_of."""
    return np_ if np_ < k5_group else max(np_ // 32, k5_group)


@pytest.mark.parametrize("n", (1, 2, 3, 4, 5, 8, 13, 16, 17, 24, 32))
def test_k5_grouped_reduction_has_the_butterflys_bits(n):
    """For N <= 32 y is summed in the first version's order, bit for bit,
    whatever the group size; states past N are zeros."""
    rng = np.random.default_rng(n)
    np_ = 1 << (n - 1).bit_length()
    k5_group = _defines("selective_scan.cu")["K5_GROUP"]
    for _ in range(50):
        p = np.zeros(np_, np.float32)
        p[:n] = (rng.normal(0, 1, n) * np.exp2(rng.integers(-8, 8, n))).astype(np.float32)
        want = _butterfly(p)
        for group in {_group_of(np_, k5_group), 1, min(2, np_), min(8, np_), np_}:
            if np_ // group <= 32:
                assert _grouped(p, group).tobytes() == want.tobytes(), (n, group)
