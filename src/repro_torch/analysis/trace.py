"""What the analyzer observes of an eager call: its aten ops and its reach.

The reference traces a jaxpr without running anything. PyTorch runs
eagerly, so the port observes a call as it runs, at the small
``sweep.TRACE_SHAPE``:

* :func:`trace_ops` records every aten op the call dispatches
  (``TorchDispatchMode``), with its shapes and dtypes and the outermost
  *opaque* function it ran in. Opaque functions are to the port what
  ``pallas_call`` bodies are to the reference's walk: the plain lane's
  kernel bodies (``edge_plain``, ``edge_stream_plain``), and the
  hysteresis fixpoint, which dilates with slices by design. A CUDA
  kernel's launch is no aten op, so on the card the trace holds exactly
  the ops the call runs around its kernels. The trace also counts the
  calls of each opaque function (FUSE002's CPU half: one plain-lane call
  per ``torch`` call).
* :func:`impulse_reach` measures how far one input pixel moves a lane's
  output (HALO001): the rows and columns between an impulse and the
  farthest output pixel it changed, with impulses at offsets 0..R+1 on
  both sides of a tile border.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["Op", "OpTrace", "trace_ops", "impulse_reach"]

# View ops whose ``dim`` argument the FUSE001 unstack allowance reads.
_DIM_OPS = ("select", "unbind", "slice")


@dataclasses.dataclass(frozen=True)
class Op:
    """One dispatched aten op: ``name`` is the overload (``aten.slice.Tensor``),
    ``packet`` its base name (``slice``); ``scope`` the outermost opaque
    function it ran in, or None."""

    name: str
    packet: str
    in_shapes: Tuple[Tuple[int, ...], ...]
    in_dtypes: Tuple[str, ...]
    out_shapes: Tuple[Tuple[int, ...], ...]
    out_dtypes: Tuple[str, ...]
    dim: Optional[int] = None
    scope: Optional[str] = None


@dataclasses.dataclass
class OpTrace:
    """The aten ops of one call, in order, and the calls of each opaque
    function (outermost calls only: ``edge_stream_plain``'s own call of
    ``edge_plain`` is part of it)."""

    ops: List[Op] = dataclasses.field(default_factory=list)
    calls: Dict[str, int] = dataclasses.field(default_factory=dict)


def _tensors(obj) -> List[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    return []


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).rsplit(".", 1)[-1]


class _Recorder(TorchDispatchMode):
    def __init__(self, trace: OpTrace, opaque: Dict[object, str], entry) -> None:
        super().__init__()
        self.trace = trace
        self.opaque = opaque
        self.entry = entry
        self.last = None  # the frame of the opaque call the last op ran in

    def _scope(self) -> Optional[str]:
        outer = None
        f = sys._getframe(2)
        while f is not None and f is not self.entry:
            if f.f_code in self.opaque:
                outer = f
            f = f.f_back
        if outer is None:
            self.last = None
            return None
        name = self.opaque[outer.f_code]
        if outer is not self.last:  # a new call (the held frame cannot be reused)
            self.trace.calls[name] = self.trace.calls.get(name, 0) + 1
            self.last = outer
        return name

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket.__name__
        dim = None
        if packet in _DIM_OPS:
            dim = args[1] if len(args) > 1 and isinstance(args[1], int) else kwargs.get("dim", 0)
        ins = _tensors(list(args) + list(kwargs.values()))
        outs = _tensors(out)
        self.trace.ops.append(Op(
            name=str(func), packet=packet,
            in_shapes=tuple(tuple(t.shape) for t in ins),
            in_dtypes=tuple(_dtype(t) for t in ins),
            out_shapes=tuple(tuple(t.shape) for t in outs),
            out_dtypes=tuple(_dtype(t) for t in outs),
            dim=dim, scope=self._scope(),
        ))
        return out


def trace_ops(fn: Callable, *args, opaque: Sequence[Callable] = (), **kwargs):
    """Run ``fn(*args, **kwargs)`` and record its aten ops: ``(result,
    OpTrace)``. Ops inside a call of a function in ``opaque`` carry its
    name as their ``scope``, and each such outermost call is counted."""
    trace = OpTrace()
    codes = {f.__code__: f.__name__ for f in opaque}
    with _Recorder(trace, codes, sys._getframe(0)) as rec:
        out = fn(*args, **kwargs)
    rec.last = None
    return out, trace


def impulse_reach(fn: Callable[[torch.Tensor], torch.Tensor], shape: Tuple[int, ...], *,
                  border: Tuple[int, int], offsets: int, dtype=torch.uint8, device="cpu",
                  seed: int = 0) -> Tuple[int, int]:
    """``(rows, cols)``: the farthest an output pixel that one input pixel
    changed lies from it, over impulses at ``0..offsets - 1`` rows and
    columns after, and before, the tile border at ``border = (row, col)``.

    ``fn`` maps a ``(B, H, W[, 3])`` batch to its ``(B, H, W)`` primary map.
    Image 0 of the batch is a textured frame from ``seed``; image ``k`` is
    the same frame with one pixel raised to 255 (every channel). Outputs
    are compared bit for bit with image 0's.
    """
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 128, shape).astype(np.float32)
    rows, cols = border
    points = [(rows + o, cols + o) for o in range(offsets)]
    points += [(rows - 1 - o, cols - 1 - o) for o in range(offsets)]
    h, w = shape[0], shape[1]
    for r, c in points:
        if not (0 <= r < h and 0 <= c < w):
            raise ValueError(f"impulse ({r}, {c}) lies outside the {h}x{w} frame")
    batch = np.repeat(base[None], len(points) + 1, axis=0)
    for k, (r, c) in enumerate(points, start=1):
        batch[k, r, c] = 255.0
    x = torch.from_numpy(batch).to(dtype).to(device)
    out = fn(x).detach().cpu()
    reach_r = reach_c = -1
    for k, (r, c) in enumerate(points, start=1):
        rr, cc = torch.nonzero(out[k] != out[0], as_tuple=True)
        if rr.numel():
            reach_r = max(reach_r, int((rr - r).abs().max()))
            reach_c = max(reach_c, int((cc - c).abs().max()))
    return reach_r, reach_c
