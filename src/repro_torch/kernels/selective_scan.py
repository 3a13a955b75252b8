"""K5, the Mamba-1 selective scan: its CUDA wrapper and its plain PyTorch version.

:func:`selective_scan` launches ``csrc/selective_scan.cu``, the Hopper port
of ``repro/kernels/selective_scan.py::_kernel``: over x, dt ``(B, L,
d_inner)``, B, C ``(B, L, N)`` and A ``(d_inner, N)``, from h = 0,

    h <- exp(dt * A) * h + (dt * x) * B,    y_t = sum_n C_t * h

in f32, y in x's dtype. It returns ``(y, h_last)``: the reference returns y
only and keeps the final state in its VMEM scratch, but the port's prefill
needs that state for the decode cache (``models/ssm.py``), so the kernel
writes it, ``(B, d_inner, N)`` in f32.

It keeps the reference's signature and its shape rule: ``chunk`` is clipped
to L and must divide it, and so ``block_d`` and d_inner; a call the
reference refuses (an ``AssertionError`` there) raises ``ValueError`` here.
With f32 elements they only gate the call: each CUDA block loops over all
of L itself and masks its ragged channel range, so ``chunk=L,
block_d=d_inner`` serves any shape. The kernel holds each channel's state
in groups of registers across the threads of one warp, which takes N up to
:data:`NMAX` (1,024).

``scan_dtype="bfloat16"`` is the Mamba-1 prefill's ``ssm_scan_dtype``:
the reference's chunked scan on bf16 elements with an f32 carry
(``repro.models.ssm.apply_mamba1``). Within each chunk of ``chunk`` steps
(q) it composes the steps' decays and inputs in bf16 and adds the carry
in f32; for each channel and state, at every t with t % q == 0, hc = h,
A = 1, Bc = 0, then

    da = bf16(exp(dt * A_dn)),  bx = bf16((dt * x) * B)
    A = bf16(A * da),  Bc = bf16(f32(da * Bc) + bx)
    h_t = A * hc + Bc (in f32, two roundings),  y_t = sum_n C_t * h_t

and the final state is the last h_t. Here ``chunk`` is no longer only a
gate: it sets where hc is refreshed. The reference composes a chunk with an
associative scan (a tree of bf16 products); this is the same recurrence
taken step by step, so the two round at other places. In K5 the elements
never leave registers, so bf16 elements change the rounding and not the
memory traffic (in the reference they halved the scan's HBM traffic).

A CUDA tensor launches the kernel or raises; a CPU tensor takes
:func:`selective_scan_plain`. ``backend="torch"`` names the plain version
on any device (the counterpart of the reference's ``interpret=True``), for
checking the kernel on the card.

As K4's, the kernel's outputs carry no ``grad_fn``: :func:`selective_scan`
on the kernel raises under autograd, and :func:`k5_scan`
(:class:`K5Scan`) is the differentiable call, K5 forward and the plain
scan recomputed and differentiated for the backward (the reference's
kernel has no backward either).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels.dispatch import refuse_detached, resolve_backend

__all__ = ["selective_scan", "selective_scan_plain", "k5_scan", "K5Scan", "NMAX",
           "SCAN_DTYPES"]

NMAX = 1024              # largest state size N csrc/selective_scan.cu instantiates
PLAIN_CHUNK = 256        # time steps whose decay and input terms the plain version holds at once
_DTYPES = (torch.float32, torch.bfloat16)   # what the kernel takes
_GRID_Y = 65535          # CUDA's limit on grid y (batch)
SCAN_DTYPES = ("float32", "bfloat16")       # the scan's element types


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (to nearest even), held in f32."""
    return t.to(torch.bfloat16).float()


def selective_scan_plain(x: torch.Tensor, dt: torch.Tensor, b_mat: torch.Tensor,
                         c_mat: torch.Tensor, a: torch.Tensor, *, scan_dtype: str = "float32",
                         chunk: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """What K5 computes, in PyTorch on any device: the sequential
    recurrence over L, vectorized over (B, d_inner, N), every input cast
    to f32, ``h * exp(dt * A) + (dt * x) * B`` rounded as two operations,
    ``y_t = sum_n C_t * h``. With ``scan_dtype="bfloat16"``, the chunked
    recurrence on bf16 elements of the module docstring, chunks of
    ``chunk`` steps (clipped to L; it must divide L). Returns ``(y in x's
    dtype, h_last (B, d_inner, N) f32)``."""
    bsz, l, di = x.shape
    n = b_mat.shape[-1]
    af = a.float()
    h = torch.zeros((bsz, di, n), dtype=torch.float32, device=x.device)
    bf16 = scan_dtype == "bfloat16"
    step = min(chunk, l) if bf16 else PLAIN_CHUNK
    ys = []
    for t0 in range(0, l, step):
        sl = slice(t0, min(t0 + step, l))
        dtc = dt[:, sl].float()
        da = torch.exp(dtc[..., None] * af)                                 # (B, q, di, N)
        bx = (dtc * x[:, sl].float())[..., None] * b_mat[:, sl, None, :].float()
        hs = torch.empty_like(da)
        if bf16:
            da, bx = _bf16(da), _bf16(bx)
            hc, acc_a, acc_b = h, None, None
            for s in range(da.shape[1]):
                acc_a = da[:, s] if acc_a is None else _bf16(acc_a * da[:, s])
                acc_b = bx[:, s] if acc_b is None else _bf16(da[:, s] * acc_b + bx[:, s])
                h = acc_a * hc + acc_b
                hs[:, s] = h
        else:
            for s in range(da.shape[1]):
                h = h * da[:, s] + bx[:, s]
                hs[:, s] = h
        ys.append((hs * c_mat[:, sl, None, :].float()).sum(-1))
    return torch.cat(ys, 1).to(x.dtype), h


def _check(x, dt, b_mat, c_mat, a, chunk: int, block_d: int, scan_dtype: str = "float32"):
    if scan_dtype not in SCAN_DTYPES:
        raise ValueError(f"scan_dtype={scan_dtype!r}; the scan takes {SCAN_DTYPES} elements")
    if x.ndim != 3 or dt.shape != x.shape:
        raise ValueError(f"selective_scan takes (B, L, d_inner) x and dt; got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}")
    bsz, l, di = x.shape
    if b_mat.ndim != 3 or tuple(b_mat.shape[:2]) != (bsz, l) or c_mat.shape != b_mat.shape:
        raise ValueError(f"B and C must be (B, L, N) = ({bsz}, {l}, N); got "
                         f"{tuple(b_mat.shape)}, {tuple(c_mat.shape)}")
    n = b_mat.shape[-1]
    if tuple(a.shape) != (di, n):
        raise ValueError(f"A must be (d_inner, N) = ({di}, {n}); got {tuple(a.shape)}")
    if not all(t.is_floating_point() for t in (x, dt, b_mat, c_mat, a)):
        raise TypeError("selective_scan takes floating-point x, dt, B, C and A")
    if min(bsz, l, di, n) == 0:
        raise ValueError(f"empty scan: x {tuple(x.shape)}, B {tuple(b_mat.shape)}")
    chunk, block_d = min(chunk, l), min(block_d, di)
    if chunk <= 0 or block_d <= 0 or l % chunk or di % block_d:
        raise ValueError(f"chunk={chunk} must divide L={l} and block_d={block_d} must divide "
                         f"d_inner={di}")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The loaded library of ``csrc/selective_scan.cu``, its entry point typed."""
    from repro_torch.kernels import build

    lib = build.load("selective_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_selective_scan_launch.argtypes = [p] * 7 + [i] * 7 + [ctypes.POINTER(i), p]
    lib.repro_selective_scan_launch.restype = i
    lib.repro_selective_scan_max_state.argtypes = []
    lib.repro_selective_scan_max_state.restype = i
    lib.repro_error_string.argtypes, lib.repro_error_string.restype = [i], ctypes.c_char_p
    if lib.repro_selective_scan_max_state() != NMAX:
        raise RuntimeError("csrc/selective_scan.cu and kernels/selective_scan.py disagree on NMAX")
    return lib


def _launch(x, dt, b_mat, c_mat, a, *, scan_dtype: str = "float32",
            chunk: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    bsz, l, di = x.shape
    n = b_mat.shape[-1]
    if any(t.device != x.device for t in (dt, b_mat, c_mat, a)):
        raise ValueError("selective_scan takes x, dt, B, C and A on one device")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (dt, b_mat, c_mat)):
        raise TypeError(f"the K5 kernel takes x, dt, B, C all float32 or all bfloat16, got "
                        f"{x.dtype}, {dt.dtype}, {b_mat.dtype}, {c_mat.dtype}")
    if n > NMAX:
        raise ValueError(f"state size N={n} exceeds the {NMAX} the K5 kernel instantiates")
    if bsz > _GRID_Y:
        raise ValueError(f"B={bsz} exceeds the CUDA grid limit {_GRID_Y}")
    x, dt, b_mat, c_mat = (t.contiguous() for t in (x, dt, b_mat, c_mat))
    a32 = a.to(torch.float32).contiguous()    # the kernel reads A in f32, as the reference casts it
    y = torch.empty_like(x)
    h_last = torch.empty((bsz, di, n), dtype=torch.float32, device=x.device)
    lib = _lib()
    route = ctypes.c_int(-1)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_selective_scan_launch(
            x.data_ptr(), dt.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(), a32.data_ptr(),
            y.data_ptr(), h_last.data_ptr(), bsz, l, di, n, int(x.dtype == torch.bfloat16),
            int(scan_dtype == "bfloat16"), min(chunk, l) if chunk > 0 else l,
            ctypes.byref(route), stream)
    if err != 0:
        text = lib.repro_error_string(err).decode()
        raise RuntimeError(f"selective_scan kernel launch failed: {text} (cudaError {err})")
    selective_scan.launches += 1
    selective_scan.async_launches += int(route.value == 1)
    selective_scan.bf16_launches += int(scan_dtype == "bfloat16")
    return y, h_last


def selective_scan(x: torch.Tensor, dt: torch.Tensor, b_mat: torch.Tensor,
                   c_mat: torch.Tensor, a: torch.Tensor, *, chunk: int = 256,
                   block_d: int = 512, backend: str = "auto", scan_dtype: str = "float32"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-1 forward scan over x, dt ``(B, L, d_inner)`` (post-conv
    input and softplus'd steps), B, C ``(B, L, N)`` and A ``(d_inner, N)``:
    K5 on a CUDA tensor, :func:`selective_scan_plain` on a CPU one. Returns
    ``(y (B, L, d_inner) in x's dtype, h_last (B, d_inner, N) f32)``.

    ``backend``: ``auto`` (by x's device), ``cuda`` (the kernel; raises for
    a CPU tensor) or ``torch`` (the plain version on any device). The
    kernel takes x, dt, B, C all f32 or all bf16 and N up to :data:`NMAX`
    (A of any float type, read in f32); it launches on PyTorch's current
    stream and does not synchronise. Raises for a call the reference
    refuses, an input the kernel does not take, or a launch the device
    refuses. ``scan_dtype`` (``float32`` or ``bfloat16``) is the scan's
    element type, with ``chunk`` the bf16 mode's chunk (the module
    docstring). ``selective_scan.launches`` counts the kernel's launches,
    ``selective_scan.async_launches`` those whose chunks were copied by
    16-byte ``cp.async`` (every row 16-byte aligned; the others use plain
    loads) and ``selective_scan.bf16_launches`` those on bf16 elements.
    """
    _check(x, dt, b_mat, c_mat, a, chunk, block_d, scan_dtype)
    if resolve_backend(backend, x.device) == "torch":
        return selective_scan_plain(x, dt, b_mat, c_mat, a, scan_dtype=scan_dtype, chunk=chunk)
    refuse_detached("selective_scan", "k5_scan", x, dt, b_mat, c_mat, a)
    return _launch(x, dt, b_mat, c_mat, a, scan_dtype=scan_dtype, chunk=chunk)


selective_scan.launches = 0
selective_scan.async_launches = 0
selective_scan.bf16_launches = 0


class K5Scan(torch.autograd.Function):
    """K5 under autograd. Forward: one launch of the kernel (counted in
    ``selective_scan.launches``) on ``scan_dtype`` elements, returning
    ``(y, h_last)``. Backward: :func:`selective_scan_plain` of the same
    element type recomputed on the saved inputs under
    ``torch.enable_grad()`` and differentiated for both outputs (its bf16
    roundings are casts, which autograd passes through); it launches
    nothing."""

    @staticmethod
    def forward(ctx, x, dt, b_mat, c_mat, a, scan_dtype="float32", chunk=0):
        ctx.save_for_backward(x, dt, b_mat, c_mat, a)
        ctx.scan = dict(scan_dtype=scan_dtype, chunk=chunk)
        return _launch(x, dt, b_mat, c_mat, a, scan_dtype=scan_dtype, chunk=chunk)

    @staticmethod
    def backward(ctx, grad_y, grad_h):
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            y, h_last = selective_scan_plain(*ins, **ctx.scan)
            grads = iter(torch.autograd.grad((y, h_last), [t for t in ins if t.requires_grad],
                                             (grad_y, grad_h), allow_unused=True))
        return tuple(next(grads) if n else None for n in need) + (None, None)


def k5_scan(x: torch.Tensor, dt: torch.Tensor, b_mat: torch.Tensor, c_mat: torch.Tensor,
            a: torch.Tensor, *, chunk: int = 256, block_d: int = 512,
            scan_dtype: str = "float32") -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`selective_scan` on the kernel, differentiable: the reference's
    shape rule, then :class:`K5Scan`. Takes what ``_launch`` takes (CUDA
    tensors); with no input that requires grad it is one launch and records
    no graph."""
    _check(x, dt, b_mat, c_mat, a, chunk, block_d, scan_dtype)
    return K5Scan.apply(x, dt, b_mat, c_mat, a, scan_dtype, chunk)
