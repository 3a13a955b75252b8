"""K1, the fused edge kernel: its CUDA wrapper and its plain PyTorch version.

``edge_cuda`` launches ``csrc/edge.cu`` (the Hopper port of
``repro/kernels/edge.py::_kernel``) on a CUDA tensor and raises on anything
else. ``edge_plain`` computes the same outputs from ``repro_torch.core``
functions on any device; the CPU lane runs it, and the kernel is held
against it on the card.

One launch takes the raw ``(N, H, W)`` u8/f32 gray or ``(N, H, W, 3)`` RGB
batch and emits the magnitude, or the ``(N, D, H, W)`` components, and
optionally the ``(N, gh, gw)`` per-tile max of the magnitude over the
``block_h x block_w`` output tiles, the source of the per-image peak.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.filters import OperatorSpec
from repro_torch.core.sobel import _pad, magnitude, spec_components
from repro_torch.kernels.tiling import PAD_MODES, luma

__all__ = [
    "edge_cuda",
    "edge_plain",
    "default_block_shape",
    "kernel_dtype",
    "window_smem_bytes",
]

_VARIANT_CODES = {"direct": 0, "separable": 1, "v1": 2, "v2": 3}
_PADDING_CODES = {p: i for i, p in enumerate(PAD_MODES)}
KMAX = 9                 # largest operator size csrc/edge.cu instantiates
SMEM_MAX = 232448        # shared memory one CTA may opt into on an H100
SMEM_DEFAULT = 48 * 1024  # default tiles stay under the no-opt-in limit


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def window_smem_bytes(block_h: int, block_w: int, radius: int) -> int:
    """Shared memory of one CTA: its f32 halo window."""
    return 4 * (block_h + 2 * radius) * (block_w + 2 * radius)


def default_block_shape(h: int, w: int, size: int = 5) -> tuple:
    """(block_h, block_w) of the CTA output tile when none is given.

    32 x 128 gives each of the 256 threads 16 pixels, with rows a multiple
    of the 32-thread warp so stores coalesce. Small images shrink the tile;
    a large operator halves it until the halo window fits ``SMEM_DEFAULT``.
    """
    r = size // 2
    bh = min(32, _round_up(h, 8))
    bw = min(128, _round_up(w, 32))
    while window_smem_bytes(bh, bw, r) > SMEM_DEFAULT and (bh > 8 or bw > 32):
        if bw >= bh and bw > 32:
            bw //= 2
        else:
            bh = max(8, bh // 2)
    return bh, bw


def kernel_dtype(x: torch.Tensor) -> torch.Tensor:
    """uint8 stays uint8 (a quarter of the input bytes; the kernel casts in
    shared memory); every other dtype is cast to float32."""
    if x.dtype == torch.uint8:
        return x
    return x.to(torch.float32)


def _dims(x: torch.Tensor, rgb: bool):
    if rgb:
        if x.ndim != 4 or x.shape[-1] != 3:
            raise ValueError(f"rgb input must be (N, H, W, 3), got {tuple(x.shape)}")
    elif x.ndim != 3:
        raise ValueError(f"gray input must be (N, H, W), got {tuple(x.shape)}")
    return x.shape[0], x.shape[1], x.shape[2]


def _grid(h: int, w: int, block_h: int, block_w) -> tuple:
    bw = block_w if block_w else w
    if block_h < 1 or bw < 1:
        raise ValueError(f"block shape must be positive, got ({block_h}, {bw})")
    return block_h, bw, -(-h // block_h), -(-w // bw)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _block_max(mag: torch.Tensor, bh: int, bw: int) -> torch.Tensor:
    """(N, H, W) -> (N, gh, gw) max over each output tile's in-image pixels."""
    n, h, w = mag.shape
    gh, gw = -(-h // bh), -(-w // bw)
    padded = mag.new_zeros((n, gh * bh, gw * bw))
    padded[:, :h, :w] = mag
    return padded.view(n, gh, bh, gw, bw).amax(dim=(2, 4))


def edge_plain(
    x: torch.Tensor,
    *,
    spec: OperatorSpec,
    variant: str,
    directions: int,
    padding: str = "reflect",
    block_h: int = 64,
    block_w: "int | None" = None,
    rgb: bool = False,
    out_components: bool = False,
    with_max: bool = False,
):
    """The plain PyTorch version of :func:`edge_cuda`: same arguments, same
    outputs, on any device.

    Luma (RGB) or the f32 cast, the boundary-extended image
    (``core.sobel._pad``), ``spec_components`` and ``magnitude``; the
    per-tile max is taken over the same ``block_h x block_w`` tiles.
    """
    n, h, w = _dims(x, rgb)
    bh, bw, _gh, _gw = _grid(h, w, block_h, block_w)
    gray = luma(x) if rgb else x.to(torch.float32)
    xp, _, _ = _pad(gray, spec.radius, padding)
    comps = spec_components(xp, spec, h, w, variant, directions)
    mag = magnitude(comps) if (with_max or not out_components) else None
    primary = torch.stack(comps, dim=1) if out_components else mag
    if not with_max:
        return primary
    return primary, _block_max(mag, bh, bw)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build

    lib = build.load("edge")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_edge_launch.argtypes = [p, i, i, i, i, i, i, i, i, i, i, i, p, p, p, p, p]
    lib.repro_edge_launch.restype = i
    lib.repro_edge_taps_len.argtypes = []
    lib.repro_edge_taps_len.restype = i
    lib.repro_edge_max_size.argtypes = []
    lib.repro_edge_max_size.restype = i
    lib.repro_edge_error_string.argtypes = [i]
    lib.repro_edge_error_string.restype = ctypes.c_char_p
    if lib.repro_edge_max_size() != KMAX:
        raise RuntimeError("csrc/edge.cu and kernels/edge.py disagree on KMAX")
    if lib.repro_edge_taps_len() != _taps_len():
        raise RuntimeError("csrc/edge.cu's Taps layout differs from _pack_taps")
    return lib


def _taps_len() -> int:
    k = KMAX
    return 4 * k * k + 4 * k + 3 * k + 2 * k * k + 4 * k


def _sym_plan(dense: np.ndarray):
    """``core.sobel._sym_rowpass``'s pass assignment: the distinct row
    vectors, and per row its pass index (-1 = zero row) and negation flag."""
    vecs, pass_of, neg = [], [], []
    index = {}
    for r_ in np.asarray(dense, np.float32):
        if not np.any(r_):
            pass_of.append(-1)
            neg.append(0)
            continue
        key, nkey = tuple(r_.tolist()), tuple((-r_).tolist())
        if key in index:
            pass_of.append(index[key])
            neg.append(0)
        elif nkey in index:
            pass_of.append(index[nkey])
            neg.append(1)
        else:
            index[key] = len(vecs)
            vecs.append(r_)
            pass_of.append(index[key])
            neg.append(0)
    return vecs, pass_of, neg


@functools.lru_cache(maxsize=64)
def _pack_taps(spec: OperatorSpec) -> np.ndarray:
    """The flat f32 ``Taps`` struct of ``csrc/edge.cu`` for ``spec``."""
    k, K = spec.size, KMAX
    dense = np.zeros((4, K, K), np.float32)
    bank = np.asarray(spec.taps, np.float32)[:4]
    dense[: len(bank), :k, :k] = bank
    col = np.zeros((2, K), np.float32)
    row = np.zeros((2, K), np.float32)
    for d in range(2):
        fac = spec.sep_factors(d)
        if fac is not None:
            col[d, :k], row[d, :k] = fac
    v2 = np.zeros((3, K), np.float32)
    if spec.v2_factors is not None:
        for a, arr in enumerate(spec.v2_arrays()):
            v2[a, :k] = arr
    sym = np.zeros((2, K, K), np.float32)
    sym_pass = np.full((2, K), -1.0, np.float32)
    sym_neg = np.zeros((2, K), np.float32)
    if 4 in spec.directions:
        for s, dm in enumerate((spec.kd_plus_dense(), spec.kd_minus_dense())):
            vecs, pass_of, neg = _sym_plan(dm)
            for p_, v in enumerate(vecs):
                sym[s, p_, :k] = v
            sym_pass[s, :k] = pass_of
            sym_neg[s, :k] = neg
    flat = np.concatenate([
        dense.ravel(), col.ravel(), row.ravel(), v2.ravel(),
        sym.ravel(), sym_pass.ravel(), sym_neg.ravel(),
    ]).astype(np.float32)
    if flat.size != _taps_len():
        raise AssertionError("Taps packing out of step with _taps_len")
    flat.setflags(write=False)
    return flat


def edge_cuda(
    x: torch.Tensor,
    *,
    spec: OperatorSpec,
    variant: str,
    directions: int,
    padding: str = "reflect",
    block_h: int = 64,
    block_w: "int | None" = None,
    rgb: bool = False,
    out_components: bool = False,
    with_max: bool = False,
):
    """Launch K1 (``csrc/edge.cu``) on a contiguous CUDA tensor.

    ``x``: ``(N, H, W)`` u8/f32 gray, or ``(N, H, W, 3)`` u8/f32 RGB when
    ``rgb``. ``variant``/``directions`` must be resolved against ``spec``.
    Returns the ``(N, H, W)`` f32 magnitude, or the ``(N, D, H, W)`` f32
    components when ``out_components``; with ``with_max`` also the
    ``(N, gh, gw)`` f32 per-tile max of the magnitude, as a tuple.

    Launches on PyTorch's current stream and does not synchronise. Raises
    for a CPU tensor, an input the kernel does not take, or a launch the
    device refuses. ``edge_cuda.launches`` counts the launches.
    """
    if x.device.type != "cuda":
        raise ValueError(
            f"edge_cuda launches a CUDA kernel and takes CUDA tensors, got a "
            f"{x.device.type} tensor; edge_plain is the plain version"
        )
    if x.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"edge_cuda takes uint8 or float32 input, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("edge_cuda takes a contiguous tensor")
    if spec.size > KMAX:
        raise ValueError(
            f"operator {spec.name!r} is {spec.size}x{spec.size}; csrc/edge.cu "
            f"instantiates sizes up to {KMAX}"
        )
    if variant not in spec.variants or directions not in spec.directions:
        raise ValueError(
            f"unresolved variant/directions {variant!r}/{directions} for operator "
            f"{spec.name!r}; resolve them with the spec first"
        )
    if variant != "direct" and (spec.sep_factors(0) is None or spec.sep_factors(1) is None):
        raise ValueError(f"operator {spec.name!r} has no separable factors for {variant!r}")
    if padding not in _PADDING_CODES:
        raise ValueError(f"unknown padding {padding!r}; expected one of {PAD_MODES}")
    n, h, w = _dims(x, rgb)
    bh, bw, gh, gw = _grid(h, w, block_h, block_w)
    smem = window_smem_bytes(bh, bw, spec.radius)
    if smem > SMEM_MAX:
        raise ValueError(
            f"tile {bh}x{bw} needs {smem} B of shared memory for its halo "
            f"window; a CTA may use at most {SMEM_MAX} B"
        )
    if n * gh * gw >= 2**31:
        raise ValueError(f"{n * gh * gw} tiles exceed the CUDA grid limit")

    mag = comps = bmax = None
    if out_components:
        comps = torch.empty((n, directions, h, w), dtype=torch.float32, device=x.device)
    else:
        mag = torch.empty((n, h, w), dtype=torch.float32, device=x.device)
    if with_max:
        bmax = torch.empty((n, gh, gw), dtype=torch.float32, device=x.device)
    if n > 0 and h > 0 and w > 0:
        lib = _lib()
        taps = _pack_taps(spec)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.repro_edge_launch(
                x.data_ptr(), int(x.dtype == torch.uint8), int(rgb), n, h, w,
                bh, bw, spec.size, _VARIANT_CODES[variant], directions,
                _PADDING_CODES[padding], taps.ctypes.data,
                None if mag is None else mag.data_ptr(),
                None if comps is None else comps.data_ptr(),
                None if bmax is None else bmax.data_ptr(),
                stream,
            )
        if err != 0:
            raise RuntimeError(
                f"edge kernel launch failed: {lib.repro_edge_error_string(err).decode()} "
                f"(cudaError {err})"
            )
        edge_cuda.launches += 1
    primary = comps if out_components else mag
    return (primary, bmax) if with_max else primary


edge_cuda.launches = 0
