"""K3's host-side rules and its work list, on the CPU.

K3 (``csrc/edge_stream.cu``) runs on a persistent grid: every CTA compacts
the int32 mask a chunk at a time into the list of changed tiles and then of
unchanged ones, walks the changed tiles and copies the unchanged ones in
bands of whole rows, by 16-byte vectors where ``stream_vector_copy``
allows. The kernel sizes and cuts its own grid and needs a card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``); here a model of the
CTAs' cursors and claims, with the source's constants, is held to covering
every item once, the copy route to the pointers, and the wrapper's
arguments to the C entry point through a stand-in library.
"""
import contextlib
import random
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.filters import get_operator
from repro_torch.kernels import edge as ekern

CSRC = Path(ekern.__file__).resolve().parent / "csrc"


def _defines() -> dict:
    text = (CSRC / "edge_stream.cu").read_text()
    return {m.group(1): int(m.group(2)) for m in re.finditer(r"#define (\w+) (\d+)\b", text)}


COPY_ITEM_FLOATS = _defines()["COPY_ITEM_FLOATS"]


def test_k3_constants_match_the_source():
    """The model below takes the copy items' size from the source. With the
    source's constants a copy thread keeps 4 loads in flight and the stream
    server's 64x256 tile is copied in two 32-row bands, the settings
    PERF.md times against 8 loads and whole-tile items."""
    got = _defines()
    assert got["COPY_LOADS"] == 4
    assert (_copy_rows(64, 256), _bands(64, 256)) == (32, 2)


# The model's copies of the kernel's rules (csrc/edge_stream.cu:
# stream_copy_rows, stream_copy_bands, stream_scan_chunk and the grid cut in
# launch()).

def _copy_rows(bh, bw):
    return max(1, min(bh, COPY_ITEM_FLOATS // bw))


def _bands(bh, bw):
    return -(-bh // _copy_rows(bh, bw))


def _scan_chunk(n_tiles, threads):
    return max(1, min(32, -(-n_tiles // threads))) * threads


def _grid(ctas, n_tiles, bh, bw):
    return min(ctas, n_tiles * _bands(bh, bw))


@pytest.mark.parametrize("bh, bw", [
    (64, 256), (8, 8), (16, 32), (64, 8192), (1, 9000), (512, 16), (100, 100), (3, 4096),
])
def test_stream_copy_rows(bh, bw):
    """A copy item is whole rows of one tile: at least one, at most the
    tile's, no more floats than COPY_ITEM_FLOATS unless one row is more."""
    rows = _copy_rows(bh, bw)
    assert 1 <= rows <= bh and (rows == 1 or rows * bw <= COPY_ITEM_FLOATS)
    assert rows == bh or (rows + 1) * bw > COPY_ITEM_FLOATS
    assert (_bands(bh, bw) - 1) * rows < bh <= _bands(bh, bw) * rows


@pytest.mark.parametrize("n_tiles, threads", [
    (1, 32), (1024, 288), (16384, 32), (10**6, 384), (2**31 - 1, 32), (288, 288), (289, 288),
])
def test_stream_scan_chunk(n_tiles, threads):
    """A chunk is a whole run of 1..32 flags a thread, and covers the mask
    in one chunk whenever 32 flags a thread do."""
    chunk = _scan_chunk(n_tiles, threads)
    assert chunk % threads == 0 and 1 <= chunk // threads <= 32
    assert chunk >= n_tiles or chunk == 32 * threads


@pytest.mark.parametrize("ctas, n_tiles, bh, bw, grid", [
    (396, 1024, 64, 256, 396), (396, 1, 8, 8, 1), (396, 2, 64, 256, 4), (132, 10**5, 8, 8, 132),
])
def test_stream_grid(ctas, n_tiles, bh, bw, grid):
    """The grid is cut to the most items a mask can make: every tile
    unchanged, in bands."""
    assert _grid(ctas, n_tiles, bh, bw) == grid


def _maps(w, offset, h=6, n=2):
    buf = torch.zeros(offset + n * h * w)
    return buf[offset:].view(n, h, w)


@pytest.mark.parametrize("w, bw, prev_offset, vec", [
    (256, 64, 0, True),    # aligned bases, w and bw multiples of 4
    (256, 64, 4, True),    # a view 16 bytes in: still on 16 bytes
    (256, 64, 1, False),   # a view 4 bytes in
    (53, 16, 53, False),   # one row into a larger buffer, w odd
    (52, 16, 52, True),    # one row in, w a multiple of 4: on 16 bytes
    (53, 16, 0, False),    # w odd: most rows off 16 bytes
    (256, 30, 0, False),   # bw not a multiple of 4: ragged tiles' rows off 16 bytes
])
def test_stream_vector_copy_follows_the_pointers(w, bw, prev_offset, vec):
    prev, out = _maps(w, prev_offset), _maps(w, 0)
    assert out.data_ptr() % 16 == 0
    assert ekern.stream_vector_copy(prev, out, w, bw) is vec


# A model of the kernel's work list (csrc/edge_stream.cu, stream_kernel):
# each CTA's cursor over the mask's chunks, its walk loop and its copy loop.

def _scan(mask, t0, per, threads, want):
    """scan_chunk: each thread's run of matching flags as bits, the items
    before its run, and the chunk's count."""
    runs = np.zeros(per * threads, bool)
    part = mask[t0:t0 + per * threads]
    runs[:part.size] = (part != 0) == want
    runs = runs.reshape(threads, per)
    bits = (runs.astype(np.int64) << np.arange(per)).sum(axis=1)
    counts = runs.sum(axis=1)
    return bits, counts, np.cumsum(counts) - counts, int(counts.sum())


class _Cta:
    def __init__(self, mask, threads):
        self.mask, self.threads = mask, threads
        self.chunk = _scan_chunk(mask.size, threads)
        self.per = self.chunk // threads
        self.start(True)

    def start(self, want):
        self.want, self.t0, self.base = want, 0, 0
        self.bits, self.counts, self.pos, self.count = _scan(self.mask, 0, self.per,
                                                             self.threads, want)

    def seek(self, k):
        while k >= self.base + self.count and self.t0 < self.mask.size - self.chunk:
            self.base += self.count
            self.t0 += self.chunk
            self.bits, self.counts, self.pos, self.count = _scan(
                self.mask, self.t0, self.per, self.threads, self.want)
        return k < self.base + self.count

    def tile(self, k):
        r = k - self.base - self.pos
        holds = (r >= 0) & (r < self.counts)
        (t,) = np.flatnonzero(holds)      # exactly one thread names the tile
        b = int(self.bits[t])
        for _ in range(int(r[t])):
            b &= b - 1
        return self.t0 + int(t) * self.per + (b & -b).bit_length() - 1


def _pick(order, live, rng):
    """The CTA that claims next: any (random), each in turn (round-robin),
    or always the first still running (first: it takes every item it can,
    the others start their copies long after it)."""
    if order == "random":
        return rng.choice(live)
    if order == "round-robin":
        live.append(live.pop(0))
        return live[-1]
    return live[0]


def _run(mask, threads, bh, bw, ctas, order, seed):
    """Every CTA's items, claimed from one counter in ``order``; returns the
    walked tiles and copied (tile, band)s."""
    flat = mask.ravel()
    bands = _bands(bh, bw)
    grid = _grid(ctas, flat.size, bh, bw)
    counter = iter(range(10**9))
    state = [{"cta": _Cta(flat, threads), "item": next(counter), "walking": True,
              "n_changed": None} for _ in range(grid)]
    walks, copies = [], []
    live = list(range(grid))
    rng = random.Random(seed)
    while live:
        b = _pick(order, live, rng)
        s = state[b]
        cta = s["cta"]
        if s["walking"]:
            if cta.seek(s["item"]):
                walks.append(cta.tile(s["item"]))
                s["item"] = next(counter)
                continue
            s["walking"], s["n_changed"] = False, cta.base + cta.count
            cta.start(False)
        j = s["item"] - s["n_changed"]
        if not cta.seek(j // bands):
            live.remove(b)
            continue
        copies.append((cta.tile(j // bands), j % bands))
        s["item"] = next(counter)
    return walks, copies, bands


def _mask(kind, shape, rng):
    m = np.zeros(shape, np.int32)
    if kind == "all":
        m[...] = 1
    elif kind == "random":
        m = rng.integers(0, 2, shape).astype(np.int32)
    elif kind == "single":
        m.flat[rng.integers(m.size)] = 1
    elif kind == "last":
        m.flat[-1] = 1
    elif kind == "block":
        m[:, shape[1] // 3: shape[1] // 3 + max(1, shape[1] // 4), :] = 1
    return m


@pytest.mark.parametrize("order", ("random", "round-robin", "first"))
@pytest.mark.parametrize("ctas", (1, 7, 396))
@pytest.mark.parametrize("kind", ("none", "all", "random", "single", "last", "block"))
@pytest.mark.parametrize("shape, threads, bh, bw", [
    ((1, 1, 1), 32, 8, 8), ((4, 32, 8), 288, 64, 256), ((2, 3, 2), 32, 16, 32),
    ((4, 64, 64), 32, 8, 8), ((1, 1, 3000), 64, 1, 3),
], ids=("1x1x1", "stream-server", "ragged", "chunks", "chunks-ragged"))
def test_work_list_covers_every_tile_once(shape, threads, bh, bw, kind, ctas, order):
    """Every changed tile is walked once and every band of every unchanged
    tile copied once, whatever the grid, the order the CTAs claim in and
    the number of chunks the mask takes (4x64x64 on 32 threads: 16
    chunks)."""
    mask = _mask(kind, shape, np.random.default_rng(len(kind)))
    walks, copies, bands = _run(mask, threads, bh, bw, ctas, order, seed=ctas)
    flat = mask.ravel()
    assert sorted(walks) == np.flatnonzero(flat).tolist()
    assert sorted(copies) == [(t, b) for t in np.flatnonzero(flat == 0).tolist()
                              for b in range(bands)]


class _FakeLib:
    """Records repro_stream_launch's arguments and returns ``err``."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def repro_stream_launch(self, *args):
        self.calls.append(args)
        return self.err

    def repro_error_string(self, err):
        return b"invalid argument"


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    streams = iter(range(1, 10**6))
    monkeypatch.setattr(ekern, "_lib", lambda name: lib)
    monkeypatch.setattr(ekern, "_check_launch", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    lib.stream = 0
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=lib.stream))
    monkeypatch.setattr(ekern, "_claims", {})
    lib.new_stream = lambda: setattr(lib, "stream", next(streams))
    return lib


# repro_stream_launch: the geometry (x, in_u8, rgb, n, h, w, bh, bw, size,
# variant, dirs, padding, nms, tan_pi8, taps), const_taps, mask, the two
# caches, the two outputs, then vec, the claim counter and the stream.
_VEC_ARG = 21


def _call(w=256, offset=0, instance="auto"):
    spec = get_operator("sobel5")
    n, h, bh, bw = 2, 40, 16, 32 if w % 4 == 0 else 16
    gh, gw = -(-h // bh), -(-w // bw)
    x = torch.zeros((n, h, w), dtype=torch.uint8)
    prev = _maps(w, offset, h=h, n=n)
    mask = torch.ones((n, gh, gw), dtype=torch.int32)
    primary, out_max = ekern.edge_stream_cuda(x, prev, torch.zeros((n, gh, gw)), mask, spec=spec,
                                              variant="v2", directions=4, block_h=bh,
                                              block_w=bw, out_nms=True, instance=instance)
    assert primary.shape == (n, h, w) and out_max.shape == (n, gh, gw)


@pytest.mark.parametrize("w, offset, vec", ((256, 0, 1), (53, 53, 0), (52, 0, 1), (256, 1, 0)),
                         ids=("aligned", "row-in-odd", "row-multiple-of-4", "off-4-bytes"))
def test_edge_stream_cuda_passes_grid_route_and_counter(fake_lib, w, offset, vec):
    """The wrapper passes the copy route and one claim counter for the
    stream, and counts every launch and the vector ones; the grid is the
    kernel's own."""
    before = (ekern.edge_stream_cuda.launches, ekern.edge_stream_cuda.vector_launches)
    for _ in range(2):
        _call(w, offset)
    first, second = fake_lib.calls
    assert len(first) == _VEC_ARG + 3 and first[_VEC_ARG] == vec
    assert first[_VEC_ARG + 1] == second[_VEC_ARG + 1]   # one counter for the stream
    assert (ekern.edge_stream_cuda.launches, ekern.edge_stream_cuda.vector_launches) == (
        before[0] + 2, before[1] + 2 * vec)


def test_claim_counter_is_one_per_stream(fake_lib):
    """Each stream gets its own zeroed counter, made once and kept: two
    streams' launches never share one."""
    _call()
    fake_lib.new_stream()
    _call()
    _call()
    a, b, c = (call[_VEC_ARG + 1] for call in fake_lib.calls)
    assert a != b and b == c
    assert [call[_VEC_ARG + 2] for call in fake_lib.calls] == [0, 1, 1]
    assert len(ekern._claims) == 2
    for counter in ekern._claims.values():
        assert counter.dtype == torch.int64 and counter.tolist() == [0, 0]


@pytest.mark.parametrize("instance, const", (("auto", 1), ("runtime", 0)))
def test_edge_stream_cuda_passes_the_instance(fake_lib, instance, const):
    _call(instance=instance)
    (call,) = fake_lib.calls
    assert call[15] == const


def test_edge_stream_cuda_raises_on_a_refused_launch(fake_lib):
    """A launch the library refuses raises and is not counted: K3 has no
    fallback."""
    fake_lib.err = 1
    before = (ekern.edge_stream_cuda.launches, ekern.edge_stream_cuda.vector_launches)
    with pytest.raises(RuntimeError, match="edge_stream kernel launch failed: invalid argument"):
        _call()
    assert (ekern.edge_stream_cuda.launches, ekern.edge_stream_cuda.vector_launches) == before
