"""How ``kernels/edge.py`` chooses K1's instance, on the CPU.

K1 (and K3, which runs K1's tile body) has a compile-time instance whose
taps are those of the default sobel5 (``SobelParams()``) with the v2
ladder at 2 or 4 directions, and a run-time-taps instance for everything
else. The choice is made by the packed taps' values, never by name. The
launches themselves need a card (``tests/test_torch_gpu.py``); here a
stand-in library records what the wrappers pass to the C entry points.
"""
import contextlib
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.filters import (SobelParams, carry_operator, get_operator,
                                      make_separable_spec)
from repro_torch.kernels import edge as ekern

HEADER = Path(ekern.__file__).resolve().parent / "csrc" / "edge_tile.cuh"

SEP9 = make_separable_spec("sep9_instance", (1.0, 8.0, 28.0, 56.0, 70.0, 56.0, 28.0, 8.0, 1.0),
                           (-1.0, -6.0, -14.0, -14.0, 0.0, 14.0, 14.0, 6.0, 1.0))


@pytest.mark.parametrize("directions", (2, 4))
def test_default_sobel5_v2_takes_the_compile_time_instance(directions):
    assert ekern.const_taps_instance(get_operator("sobel5"), "v2", directions)


def test_a_carried_copy_of_the_default_taps_takes_it_too():
    """By value: the same taps under another name run the same constants."""
    s = get_operator("sobel5")
    carried = carry_operator("sobel5_copy", size=s.size, directions=s.directions,
                             variants=s.variants, taps=np.asarray(s.taps),
                             sep=[s.sep_factors(d) for d in range(len(s.sep))],
                             v2_factors=s.v2_arrays())
    assert carried.name != s.name
    assert ekern.const_taps_instance(carried, "v2", 4)


@pytest.mark.parametrize("params", (SobelParams(b=3.0), SobelParams(m=8.0, n=5.0),
                                    SobelParams(a=2.0)), ids=lambda p: str(p.as_tuple()))
@pytest.mark.parametrize("directions", (2, 4))
def test_sobel5_with_other_weights_takes_the_run_time_path(params, directions):
    spec = get_operator("sobel5", params)
    assert spec.name == "sobel5"
    assert not ekern.const_taps_instance(spec, "v2", directions)


@pytest.mark.parametrize("variant", ("direct", "separable", "v1"))
@pytest.mark.parametrize("directions", (2, 4))
def test_other_variants_of_sobel5_take_the_run_time_path(variant, directions):
    assert not ekern.const_taps_instance(get_operator("sobel5"), variant, directions)


@pytest.mark.parametrize("op", ("sobel3", "sobel7", "scharr3", "prewitt3", "sep9"))
def test_other_operators_take_the_run_time_path(op):
    spec = SEP9 if op == "sep9" else get_operator(op)
    for variant in spec.variants:
        for d in spec.directions:
            assert not ekern.const_taps_instance(spec, variant, d), (variant, d)


def _header_taps() -> dict:
    """``Sobel5Default``'s Taps5 constants, by accessor, from the header."""
    text = HEADER.read_text()
    body = text[text.index("struct Sobel5Default"):text.index("// Run-time taps")]
    out = {}
    for m in re.finditer(r"Taps5<([-\d, ]+)>\s+(\w+)\(\)", body):
        out[m.group(2)] = [float(v) for v in m.group(1).split(",")]
    passes = re.findall(r"return Taps5<([-\d, ]+)>\{\}", body)
    out["sym"] = [[float(v) for v in p.split(",")] for p in passes]
    return out


def test_compile_time_taps_are_the_packed_default_sobel5():
    """The constants in edge_tile.cuh equal _pack_taps(get_operator("sobel5"))
    field by field (the library repeats this check when it loads)."""
    t = _header_taps()
    K, k = ekern.KMAX, 5
    flat = ekern._pack_taps(get_operator("sobel5"))
    off = ekern._taps_offsets()
    o_col, o_row, o_v2, o_sym = off["col"], off["row"], off["v2"], off["sym"]
    o_pass, o_neg = off["sym_pass"], off["sym_neg"]
    assert (o_col, o_row, o_v2) == (4 * K * K, 4 * K * K + 2 * K, 4 * K * K + 4 * K)

    def vec(off):
        return flat[off:off + k].tolist()

    assert t["col_x"] == vec(o_col) and t["col_y"] == vec(o_col + K)
    assert t["row_f"] == vec(o_row) and t["row_s"] == vec(o_row + K)
    assert [t["col_f"], t["col_d"], t["row_d"]] == [vec(o_v2 + i * K) for i in range(3)]
    assert t["sym"] == [vec(o_sym + p * K) for p in range(2)]
    assert not flat[o_sym + 2 * K:o_sym + K * K].any()   # K_d+ has exactly two passes
    assert t["sym_pass"] == vec(o_pass) and t["sym_neg"] == vec(o_neg)
    fields = ekern._default_fields()
    assert len(fields) == len(set(fields.tolist())) == 18 * k


class _FakeLib:
    """Records the arguments of the C entry points; every launch succeeds."""

    def __init__(self):
        self.calls = []

    def repro_edge_launch(self, *args):
        self.calls.append(("edge", args))
        return 0

    def repro_stream_launch(self, *args):
        self.calls.append(("stream", args))
        return 0


@pytest.fixture
def fake_launch(monkeypatch):
    """edge_cuda and edge_stream_cuda on CPU tensors, into a recording library."""
    lib = _FakeLib()
    monkeypatch.setattr(ekern, "_lib", lambda name: lib)
    monkeypatch.setattr(ekern, "_check_launch", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    return lib


# The geometry the entry points take first: x, in_u8, rgb, n, h, w, bh, bw,
# size, variant, dirs, padding, nms, tan_pi8, taps; then K1's const_taps.
_CONST_ARG = 15


@pytest.mark.parametrize("case", [
    ("sobel5", None, "v2", 4, "auto", 1),
    ("sobel5", None, "v2", 2, "auto", 1),
    ("sobel5", None, "v2", 4, "runtime", 0),
    ("sobel5", SobelParams(b=3.0), "v2", 4, "auto", 0),
    ("sobel5", None, "v1", 4, "auto", 0),
    ("sobel5", None, "separable", 2, "auto", 0),
    ("sobel3", None, "separable", 2, "auto", 0),
    ("sobel7", None, "direct", 2, "auto", 0),
], ids=lambda c: f"{c[0]}-{c[2]}-{c[3]}-{c[4]}-{'custom' if c[1] else 'default'}")
@pytest.mark.parametrize("lane", ("f32", "int", "nms"))
def test_edge_cuda_passes_the_instance_and_counts_k1(fake_launch, case, lane):
    op, params, variant, directions, instance, const = case
    spec = get_operator(op, params)
    x = torch.zeros((1, 40, 50), dtype=torch.uint8)
    counts = (ekern.edge_cuda.launches, ekern.edge_cuda.int_launches,
              ekern.edge_cuda.const_launches)
    out = ekern.edge_cuda(x, spec=spec, variant=variant, directions=directions, block_h=16,
                          block_w=32, instance=instance, precision="int" if lane == "int" else "f32",
                          out_nms=lane == "nms", with_max=True)
    assert isinstance(out, tuple) and out[1].shape == (1, 3, 2)
    (name, args), = fake_launch.calls
    assert name == "edge" and args[_CONST_ARG] == const
    assert args[_CONST_ARG + 1] == int(lane == "int")        # acc_int
    assert (ekern.edge_cuda.launches, ekern.edge_cuda.int_launches,
            ekern.edge_cuda.const_launches) == (counts[0] + 1, counts[1] + int(lane == "int"),
                                                counts[2] + const)


@pytest.mark.parametrize("instance, const", (("auto", 1), ("runtime", 0)))
def test_edge_stream_cuda_passes_the_instance(fake_launch, instance, const):
    spec = get_operator("sobel5")
    x = torch.zeros((1, 40, 50), dtype=torch.uint8)
    prev = torch.zeros((1, 40, 50))
    bmax = torch.zeros((1, 3, 2))
    mask = torch.ones((1, 3, 2), dtype=torch.int32)
    before = ekern.edge_stream_cuda.launches
    ekern.edge_stream_cuda(x, prev, bmax, mask, spec=spec, variant="v2", directions=4,
                           block_h=16, block_w=32, out_nms=True, instance=instance)
    (name, args), = fake_launch.calls
    assert name == "stream" and args[_CONST_ARG] == const
    assert ekern.edge_stream_cuda.launches == before + 1


def test_pipelined_depths_ignore_the_instance(fake_launch, monkeypatch):
    """edge_cuda forwards a ring depth to K2 unchanged, and the instance with
    it: K2 runs K1's walk on either instance."""
    seen = {}
    monkeypatch.setattr(ekern, "edge_pipelined_cuda", lambda x, **kw: seen.update(kw) or "k2")
    out = ekern.edge_cuda(torch.zeros((1, 8, 8)), spec=get_operator("sobel5"), variant="v2",
                          directions=4, pipeline_depth=2, instance="runtime")
    assert out == "k2" and seen["instance"] == "runtime" and seen["pipeline_depth"] == 2
    assert not fake_launch.calls


@pytest.mark.parametrize("fn", ("edge_cuda", "edge_stream_cuda"))
def test_unknown_instance_raises(fn):
    x = torch.zeros((1, 8, 8))
    args = (x,) if fn == "edge_cuda" else (x, x, torch.zeros((1, 1, 1)),
                                            torch.ones((1, 1, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="instance"):
        getattr(ekern, fn)(*args, spec=get_operator("sobel5"), variant="v2", directions=4,
                           instance="constant")
