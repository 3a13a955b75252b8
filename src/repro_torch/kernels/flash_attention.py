"""K4, flash attention: its CUDA wrapper and its plain PyTorch version.

:func:`flash_attention` launches ``csrc/flash_attention.cu``, the Hopper port
of ``repro/kernels/flash_attention.py::_kernel``: attention over
``(B, H, S, D)`` q and ``(B, H, T, D)`` k and v (KV heads repeated for GQA
upstream) with an online softmax in f32, causal by index (row >= col, the
rest masked to -1e30), output ``acc / max(l, 1e-30)`` in q's dtype.

It keeps the reference's signature and its shape rule: ``block_q`` is
clipped to S and must divide it, and so for ``block_kv`` and T; a call the
reference refuses is refused here. The blocks only gate the call: the CUDA
kernel tiles by 64 and masks its ragged last tiles, so ``block_q=S,
block_kv=T`` serves any length.

A CUDA tensor launches the kernel or raises; a CPU tensor takes
:func:`flash_attention_plain`. ``backend="torch"`` names the plain version
on any device (the counterpart of the reference's ``interpret=True``), for
checking the kernel on the card.

The kernel's output is written through ``ctypes`` and carries no
``grad_fn``, so :func:`flash_attention` on the kernel raises under autograd
(grad mode on and an input that requires grad) instead of cutting the
graph. :func:`k4_attention` (:class:`K4Attention`) is the differentiable
call: K4 runs the forward; the backward recomputes
:func:`flash_attention_plain` on the saved q, k, v and differentiates it.
The reference's kernel has no backward (no ``custom_vjp``; its trainer
differentiates XLA ops), so neither has the port's: the recompute holds
S x T f32 scores a head, 16 MB a layer at llama3.2-1b's training shape (8,
32, 128, 64).
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.kernels.dispatch import refuse_detached, resolve_backend

__all__ = ["flash_attention", "flash_attention_plain", "k4_attention", "K4Attention", "DMAX"]

DMAX = 128               # largest head dim csrc/flash_attention.cu instantiates
_NEG = -1e30
_DTYPES = (torch.float32, torch.bfloat16)   # what the kernel takes
_GRID_YZ = 65535         # CUDA's limit on grid y (heads) and z (batch)


def _scale(d: int) -> float:
    """``1/sqrt(D)`` as the reference's kernel applies it: an f32 multiplier."""
    return float(np.float32(1.0 / math.sqrt(d)))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True) -> torch.Tensor:
    """What K4 computes, in PyTorch on any device: q scaled in f32, the
    scores in f32, the -1e30 mask by index, a softmax taken as
    ``exp(s - max) / max(sum, 1e-30)``, the output in q's dtype."""
    s_len, t_len, d = q.shape[2], k.shape[2], q.shape[3]
    s = (q.float() * _scale(d)) @ k.float().transpose(-1, -2)
    if causal:
        keep = (torch.arange(s_len, device=q.device)[:, None]
                >= torch.arange(t_len, device=q.device)[None, :])
        s = torch.where(keep, s, _NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    return ((p @ v.float()) / torch.clamp(l, min=1e-30)).to(q.dtype)


def _check(q, k, v, block_q: int, block_kv: int):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes (B, H, S, D) q and (B, H, T, D) k, v; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s_len, d = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, h, d):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} in B, H, D "
                         "(repeat KV heads for GQA upstream)")
    if not (q.is_floating_point() and k.is_floating_point() and v.is_floating_point()):
        raise TypeError("flash_attention takes floating-point q, k, v")
    t_len = k.shape[2]
    if min(q.shape) == 0 or t_len == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    block_q, block_kv = min(block_q, s_len), min(block_kv, t_len)
    if block_q <= 0 or block_kv <= 0 or s_len % block_q or t_len % block_kv:
        raise ValueError(f"block_q={block_q} must divide S={s_len} and block_kv={block_kv} "
                         f"must divide T={t_len}")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The loaded library of ``csrc/flash_attention.cu``, its entry point typed."""
    from repro_torch.kernels import build

    lib = build.load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_flash_attention_launch.argtypes = [p, p, p, p] + [i] * 7 + [ctypes.c_float, p]
    lib.repro_flash_attention_launch.restype = i
    lib.repro_flash_max_dim.argtypes, lib.repro_flash_max_dim.restype = [], i
    lib.repro_error_string.argtypes, lib.repro_error_string.restype = [i], ctypes.c_char_p
    if lib.repro_flash_max_dim() != DMAX:
        raise RuntimeError("csrc/flash_attention.cu and kernels/flash_attention.py disagree "
                           "on DMAX")
    return lib


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    b, h, s_len, d = q.shape
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention takes q, k, v on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the K4 kernel takes q, k, v all float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d > DMAX:
        raise ValueError(f"head dim {d} exceeds the {DMAX} the K4 kernel instantiates")
    if h > _GRID_YZ or b > _GRID_YZ:
        raise ValueError(f"B={b} or H={h} exceeds the CUDA grid limit {_GRID_YZ}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, s_len, k.shape[2],
            d, int(causal), int(q.dtype == torch.bfloat16), _scale(d), stream)
    if err != 0:
        text = lib.repro_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {text} (cudaError {err})")
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    block_q: int = 128, block_kv: int = 128,
                    backend: str = "auto") -> torch.Tensor:
    """Attention over ``(B, H, S, D)`` q and ``(B, H, T, D)`` k, v: K4 on a
    CUDA tensor, :func:`flash_attention_plain` on a CPU one.

    ``backend``: ``auto`` (by q's device), ``cuda`` (the kernel; raises for
    a CPU tensor) or ``torch`` (the plain version on any device). The
    kernel takes f32 or bf16 (all three alike) and head dims up to
    :data:`DMAX`; it launches on PyTorch's current stream and does not
    synchronise. Raises for a call the reference refuses, an input the
    kernel does not take, or a launch the device refuses.
    ``flash_attention.launches`` counts the kernel's launches.
    """
    _check(q, k, v, block_q, block_kv)
    if resolve_backend(backend, q.device) == "torch":
        return flash_attention_plain(q, k, v, causal=causal)
    refuse_detached("flash_attention", "k4_attention", q, k, v)
    return _launch(q, k, v, causal)


flash_attention.launches = 0


class K4Attention(torch.autograd.Function):
    """K4 under autograd. Forward: one launch of the kernel (counted in
    ``flash_attention.launches``). Backward: :func:`flash_attention_plain`
    recomputed on the saved q, k, v under ``torch.enable_grad()`` and
    differentiated by ``torch.autograd.grad``; it launches nothing."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _launch(q, k, v, causal)

    @staticmethod
    def backward(ctx, grad_out):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            out = flash_attention_plain(*ins, causal=ctx.causal)
            grads = iter(torch.autograd.grad(out, [t for t in ins if t.requires_grad],
                                             grad_out))
        return tuple(next(grads) if n else None for n in need) + (None,)


def k4_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                 block_q: int = 128, block_kv: int = 128) -> torch.Tensor:
    """:func:`flash_attention` on the kernel, differentiable: the reference's
    shape rule, then :class:`K4Attention`. Takes what ``_launch`` takes
    (CUDA tensors); with no input that requires grad it is one launch and
    records no graph."""
    _check(q, k, v, block_q, block_kv)
    return K4Attention.apply(q, k, v, causal)
