"""State-space models: Mamba-1, with kernel K5 for the prefill's scan, and
Mamba-2 (SSD) in plain PyTorch.

The port of ``repro.models.ssm``. For Mamba-1 the reference computes the
prefill's scan with an outer ``lax.scan`` over chunks carrying the
``(B, d_inner, N)`` state and a parallel associative scan inside each
chunk; the port runs the same recurrence through K5 on a CUDA tensor (one
launch a layer, through :func:`repro_torch.kernels.selective_scan.k5_scan`,
whose backward recomputes the plain scan), its plain sequential version
(:func:`~repro_torch.kernels.selective_scan.selective_scan`) on a CPU one
or with ``backend="torch"``. K5 also returns the final state, which the
decode cache needs (the reference takes it from its scan's carry).

On a mesh (training) each ``model`` position runs its own channels
(:func:`mamba1_mesh`, K5 included) or its own heads (:func:`mamba2_mesh`),
and the row-parallel products are summed over ``model``.

Decode is O(1) a token and plain PyTorch: the cache carries the SSM state
``h`` (f32) and the depthwise conv's tail.

``ssm_scan_dtype="bfloat16"`` runs the prefill's scan as the reference
does: chunks of ``_pick_chunk(L, ssm_chunk)`` steps (falcon-mamba: 16)
whose decays and inputs are composed in bf16, carried across chunks in
f32 (K5's bf16-element mode on the card, ``selective_scan_plain``'s on
the CPU; ``kernels/selective_scan.py`` gives the arithmetic). In K5 the
elements never leave registers, so bf16 elements change the rounding,
not the memory traffic (in the reference they halved the scan's HBM
traffic). The decode step stays f32, as the reference's does; any other
element type raises.

Mamba-2 (zamba2's backbone) follows the reference's SSD block
decomposition: within a chunk a masked quadratic term, across chunks a
recurrence of the chunk states. The reference computes it with XLA ops
outside any Pallas kernel, so the port keeps it in PyTorch ops on both
lanes. Each three-operand einsum of the reference is contracted pairwise,
the sum over the chunk's positions (or the state) as a batched matmul, so
no ``(b, c, q, q, h, p)`` product is ever built (~10.7 GB at zamba2's FULL
width and 2,048 tokens); the reference's associative scan over chunks is a
loop over them (the same recurrence, ``h = h * decay + state``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dispatch import resolve_backend, resolve_device
from repro_torch.kernels.selective_scan import SCAN_DTYPES, k5_scan, selective_scan
from repro_torch.models.layers import Spec

__all__ = [
    "mamba1_params",
    "apply_mamba1",
    "mamba1_mesh",
    "mamba1_decode",
    "init_mamba1_cache",
    "mamba2_params",
    "apply_mamba2",
    "mamba2_mesh",
    "mamba2_decode",
    "init_mamba2_cache",
]


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time. x: (B, L, C), w: (C, K), b: (C,).

    If ``tail`` (B, K-1, C) is given (decode), it is prepended instead of
    zero-padding. Returns the output and the new tail, the last K-1 rows
    of the (padded) input.
    """
    k = w.shape[1]
    if tail is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([tail.to(x.dtype), x], dim=1)
    out = None
    l = x.shape[1]
    for t in range(k):
        term = xp[:, t:t + l, :] * w[:, t]
        out = term if out is None else out + term
    out = out + b
    new_tail = xp[:, -(k - 1):, :] if k > 1 else None
    return out, new_tail


def _pick_chunk(l: int, target: int) -> int:
    """Largest divisor of ``l`` that is <= target (falls back to 1)."""
    q = min(target, l)
    while l % q != 0:
        q -= 1
    return max(q, 1)


def mamba1_params(cfg: ModelConfig) -> Dict[str, Spec]:
    d, di, n, r, k = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_dt_rank, cfg.ssm_conv
    return {
        "in_proj": Spec((d, 2 * di), ("embed", "ssm_inner")),
        "conv_w": Spec((di, k), ("ssm_inner", None), "normal"),
        "conv_b": Spec((di,), ("ssm_inner",), "zeros"),
        "x_proj": Spec((di, r + 2 * n), ("ssm_inner", None)),
        "dt_w": Spec((r, di), (None, "ssm_inner")),
        "dt_b": Spec((di,), ("ssm_inner",), "dt_bias"),
        "a_log": Spec((di, n), ("ssm_inner", None), "mamba1_alog"),
        "d_skip": Spec((di,), ("ssm_inner",), "ones"),
        "out_proj": Spec((di, d), ("ssm_inner", "embed")),
    }


def _mamba1_conv(params, xin: torch.Tensor, conv_tail=None):
    """The depthwise causal conv and SiLU of the channels ``params`` holds.
    Returns (xc, new conv tail)."""
    dtype = xin.dtype
    xc, new_tail = _causal_conv(xin, params["conv_w"].to(dtype), params["conv_b"].to(dtype),
                                conv_tail)
    return F.silu(xc), new_tail


def _mamba1_steps(params, cfg: ModelConfig, proj: torch.Tensor, dtype):
    """(dt, A, B, C) in f32 from ``x_proj``'s output (the whole sum over
    d_inner), for the channels ``params`` holds."""
    r, n = cfg.ssm_dt_rank, cfg.ssm_state
    dt_raw, b_mat, c_mat = proj[..., :r], proj[..., r:r + n], proj[..., r + n:]
    dt = F.softplus(dt_raw @ params["dt_w"].to(dtype) + params["dt_b"].to(dtype)).float()
    a = -torch.exp(params["a_log"].float())                 # (di, n)
    return dt, a, b_mat.float(), c_mat.float()


def _mamba1_inputs(params, cfg: ModelConfig, x: torch.Tensor, conv_tail=None):
    """(xc, z, dt, A, B, C, new conv tail, the conv's raw input) of one
    Mamba-1 block on x (B, L, d_model); dt, A, B and C in f32."""
    dtype = x.dtype
    di = cfg.d_inner
    xz = x @ params["in_proj"].to(dtype)
    xin, z = xz[..., :di], xz[..., di:]
    xc, new_tail = _mamba1_conv(params, xin, conv_tail)
    proj = xc @ params["x_proj"].to(dtype)
    dt, a, b_mat, c_mat = _mamba1_steps(params, cfg, proj, dtype)
    return xc, z, dt, a, b_mat, c_mat, new_tail, xin


def _mamba1_scan(params, cfg: ModelConfig, xc, z, dt, a, b_mat, c_mat, backend: str):
    """The selective scan over the channels of xc (K5 on the card lane) on
    ``cfg.ssm_scan_dtype`` elements, the skip term and the gate: (y in
    xc's dtype, the final state)."""
    dtype = xc.dtype
    xf = xc.float()
    gates = dict(chunk=_pick_chunk(xc.shape[1], cfg.ssm_chunk), block_d=xc.shape[-1],
                 scan_dtype=_scan_dtype(cfg))
    if resolve_backend(backend, xc.device) == "cuda":
        y, h_last = k5_scan(xf, dt, b_mat, c_mat, a, **gates)       # differentiable
    else:
        y, h_last = selective_scan(xf, dt, b_mat, c_mat, a, backend="torch", **gates)
    y = y + params["d_skip"].float() * xf
    return y.to(dtype) * F.silu(z), h_last


def apply_mamba1(params: Dict, cfg: ModelConfig, x: torch.Tensor, return_cache: bool = False,
                 *, backend: str = "auto"):
    """Prefill forward. x: (B, L, d_model). With ``return_cache``, also the
    decode cache ``{"h": K5's final state, "conv": the last K-1 rows of the
    conv's zero-padded input}`` (the reference's ``xin_raw[:, -(K-1):]``
    wherever L >= K-1).

    ``backend``: ``auto`` (K5 for a CUDA tensor, the plain scan for a CPU
    one), ``cuda`` or ``torch`` (the plain scan on any device). K5's
    ``chunk`` is the reference's scan chunk (``_pick_chunk(L,
    ssm_chunk)``) and its ``block_d`` is d_inner: both divide; on f32
    elements both only gate the kernel, on bf16 ones the chunk is where
    the f32 carry is taken.
    """
    xc, z, dt, a, b_mat, c_mat, new_tail, _ = _mamba1_inputs(params, cfg, x)
    y, h_last = _mamba1_scan(params, cfg, xc, z, dt, a, b_mat, c_mat, backend)
    out = y @ params["out_proj"].to(x.dtype)
    if return_cache:
        return out, {"h": h_last, "conv": new_tail}
    return out


def _scan_dtype(cfg: ModelConfig) -> str:
    """The prefill scan's element type, ``float32`` or ``bfloat16``;
    raises for any other."""
    if cfg.ssm_scan_dtype not in SCAN_DTYPES:
        raise NotImplementedError(f"ssm_scan_dtype={cfg.ssm_scan_dtype!r}: the port scans on "
                                  f"{' or '.join(SCAN_DTYPES)} elements")
    return cfg.ssm_scan_dtype


def mamba1_mesh(lps: Dict[Any, Dict], cfg: ModelConfig, x: Dict[Any, torch.Tensor], mesh, *,
                backend: str = "auto") -> Dict[Any, torch.Tensor]:
    """Mamba-1 on a mesh, for training. ``lps`` holds each position's block
    weights (its own ``ssm_inner`` channels where ``model`` splits them,
    the rest whole), ``x`` each position's normed input (B_l, L, d_model).

    Each position computes its own channels: the conv, ``dt_w``, ``dt_b``,
    ``a_log`` and ``d_skip`` are per channel, and the scan (K5 on the
    card, at (B_l, L, d_inner / |model|, N)) is per channel too. Split as
    stored, ``in_proj``'s columns put the ``x`` half at the first
    positions and the ``z`` half at the last; so its partial products are
    all-gathered over ``model`` and each position takes its channels of
    both halves. ``x_proj`` is row-parallel: its partial dt/B/C products
    are summed over ``model`` before the softplus; so is ``out_proj``'s
    output. Where ``model`` splits nothing every position computes the
    whole block and nothing is summed. Returns each position's output."""
    from repro_torch.sharding.placed import all_gather, all_reduce

    di = cfg.d_inner
    mi = mesh.axis_names.index("model") if "model" in mesh.axis_names else None
    lp0 = next(iter(lps.values()))
    d_l = lp0["conv_b"].shape[0]
    xz = {pos: x[pos] @ lp["in_proj"].to(x[pos].dtype) for pos, lp in lps.items()}
    if lp0["in_proj"].shape[-1] < 2 * di:
        xz = all_gather(xz, mesh, "model", -1)
    xc, z, proj = {}, {}, {}
    for pos, lp in lps.items():
        c0 = pos[mi] * d_l if d_l < di else 0
        xc[pos], _ = _mamba1_conv(lp, xz[pos][..., c0:c0 + d_l])
        z[pos] = xz[pos][..., di + c0:di + c0 + d_l]
        proj[pos] = xc[pos] @ lp["x_proj"].to(xc[pos].dtype)
    if d_l < di:
        proj = all_reduce(proj, mesh, "model")
    out = {}
    for pos, lp in lps.items():
        steps = _mamba1_steps(lp, cfg, proj[pos], xc[pos].dtype)
        y, _ = _mamba1_scan(lp, cfg, xc[pos], z[pos], *steps, backend)
        out[pos] = y @ lp["out_proj"].to(y.dtype)
    return all_reduce(out, mesh, "model") if d_l < di else out


def init_mamba1_cache(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None) -> Dict:
    """Zero state and conv tail for ``batch`` sequences, on ``device``
    (``None`` = the CUDA device)."""
    dev = resolve_device(device)
    return {
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32, device=dev),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=dtype, device=dev),
    }


def mamba1_decode(params: Dict, cfg: ModelConfig, x: torch.Tensor, cache: Dict):
    """One token. x: (B, 1, d_model). One step of the recurrence, with the
    plain scan's arithmetic; returns (out, new cache) and leaves ``cache``
    as it was."""
    dtype = x.dtype
    xc, z, dt, a, b_mat, c_mat, new_tail, _ = _mamba1_inputs(params, cfg, x, cache["conv"])
    da = torch.exp(dt[:, 0, :, None] * a)                    # (B, di, n)
    bx = (dt[:, 0] * xc[:, 0].float())[..., None] * b_mat[:, 0, None, :]
    h = cache["h"] * da + bx
    y = (h * c_mat[:, 0, None, :]).sum(-1)
    y = y + params["d_skip"].float() * xc[:, 0].float()
    y = y.to(dtype)[:, None, :] * F.silu(z)
    out = y @ params["out_proj"].to(dtype)
    return out, {"h": h, "conv": new_tail}


# ---------------------------------------------------------------------------
# Mamba-2 (SSD)
# ---------------------------------------------------------------------------

def mamba2_params(cfg: ModelConfig) -> Dict[str, Spec]:
    d, di, n, k = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    nh = cfg.ssm_heads
    return {
        "wz": Spec((d, di), ("embed", "ssm_inner")),
        "wx": Spec((d, di), ("embed", "ssm_inner")),
        "wb": Spec((d, n), ("embed", None)),
        "wc": Spec((d, n), ("embed", None)),
        "wdt": Spec((d, nh), ("embed", "ssm_heads")),
        "conv_w": Spec((di + 2 * n, k), (None, None), "normal"),
        "conv_b": Spec((di + 2 * n,), (None,), "zeros"),
        "a_log": Spec((nh,), (None,), "mamba2_alog"),
        "dt_b": Spec((nh,), (None,), "dt_bias"),
        "d_skip": Spec((nh,), (None,), "ones"),
        "norm": Spec((di,), ("ssm_inner",), "ones"),
        "out_proj": Spec((di, d), ("ssm_inner", "embed")),
    }


def _mamba2_inputs(params, cfg: ModelConfig, x: torch.Tensor, conv_tail=None):
    """(x, z, dt, A, B, C, new conv tail, the conv's raw input) of one
    Mamba-2 block on x (B, L, d_model); dt (per head), A, B and C in f32.
    The channels and heads are the ones ``params`` holds (on a mesh, a
    position's own: ``mamba2_mesh``)."""
    dtype = x.dtype
    di, n = params["wx"].shape[-1], cfg.ssm_state
    z = x @ params["wz"].to(dtype)
    xin = x @ params["wx"].to(dtype)
    b_in = x @ params["wb"].to(dtype)
    c_in = x @ params["wc"].to(dtype)
    dt_in = x @ params["wdt"].to(dtype)
    xbc_raw = torch.cat([xin, b_in, c_in], dim=-1)
    xbc, new_tail = _causal_conv(xbc_raw, params["conv_w"].to(dtype),
                                 params["conv_b"].to(dtype), conv_tail)
    xbc = F.silu(xbc)
    xin, b_mat, c_mat = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt_in.float() + params["dt_b"].float())
    a = -torch.exp(params["a_log"].float())                 # (nh,)
    return xin, z, dt, a, b_mat.float(), c_mat.float(), new_tail, xbc_raw


def _gate(y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """y * silu(z) in y's dtype, then in f32: the gated RMSNorm's input."""
    return (y * F.silu(z)).float()


def _rms_scale(params, cfg: ModelConfig, yf: torch.Tensor, mean_sq: torch.Tensor,
               dtype) -> torch.Tensor:
    """The gated RMSNorm's output from its f32 input ``yf`` and the mean
    square over all of ``d_inner``, back to ``dtype``."""
    yf = yf * torch.rsqrt(mean_sq + cfg.norm_eps)
    return (yf * params["norm"].float()).to(dtype)


def _gated_norm(params, cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Mamba-2's gated RMSNorm: norm(y * silu(z)), in f32, back to y's dtype."""
    yf = _gate(y, z)
    return _rms_scale(params, cfg, yf, (yf * yf).mean(dim=-1, keepdim=True), y.dtype)


def _ssd(cfg: ModelConfig, xin, dt, a, b_mat, c_mat, d_skip):
    """The SSD over the heads of ``dt`` (B, L, heads), with the skip term:
    (y (B, L, heads * head_dim) in f32, the state after the last chunk
    (B, heads, head_dim, N))."""
    b, l, nh = dt.shape
    p, n = cfg.ssm_head_dim, cfg.ssm_state
    q = _pick_chunk(l, cfg.ssm_chunk)
    nc = l // q

    xh = xin.float().reshape(b, nc, q, nh, p)
    dt_c = dt.reshape(b, nc, q, nh)
    b_c = b_mat.reshape(b, nc, q, n)
    c_c = c_mat.reshape(b, nc, q, n)

    cum = torch.cumsum(dt_c * a, dim=2)                      # (b, c, q, h)
    # intra-chunk: L[i, j] = exp(cum_i - cum_j) for i >= j. Masked BEFORE the
    # exp: the i < j region has positive exponents that overflow.
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (b, c, qi, qj, h)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xin.device))
    l_mat = torch.exp(torch.where(tri[None, None, :, :, None], seg, -1e30))
    xdt = xh * dt_c[..., None]                               # (b, c, q, h, p)
    cb = c_c @ b_c.transpose(-1, -2)                         # "bcin,bcjn->bcij"
    # "bcij,bcijh,bcjhp->bcihp": the weights first, then the sum over j.
    w = (cb[..., None] * l_mat).permute(0, 1, 4, 2, 3)       # (b, c, h, i, j)
    y_diag = (w @ xdt.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)   # (b, c, i, h, p)

    # chunk states: "bcjn,bcjh,bcjhp->bchpn", the sum over j as a matmul
    decay_state = torch.exp(cum[:, :, -1:, :] - cum)         # (b, c, q, h)
    u = (xdt * decay_state[..., None]).permute(0, 1, 3, 4, 2).reshape(b, nc, nh * p, q)
    states = (u @ b_c).reshape(b, nc, nh, p, n)
    # the state entering each chunk: h_c = h_{c-1} * exp(cum_last) + states_c
    chunk_decay = torch.exp(cum[:, :, -1, :])                # (b, c, h)
    h = torch.zeros((b, nh, p, n), dtype=states.dtype, device=xin.device)
    prev = []
    for c in range(nc):
        prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)                          # (b, c, h, p, n)
    # "bcin,bchpn,bcih->bcihp": C against the entering state, then the decay
    y_off = (c_c @ prev.reshape(b, nc, nh * p, n).transpose(-1, -2)).reshape(b, nc, q, nh, p)
    y_off = y_off * torch.exp(cum)[..., None]

    y = (y_diag + y_off).reshape(b, l, nh, p)
    y = y + d_skip.float()[:, None] * xin.float().reshape(b, l, nh, p)
    return y.reshape(b, l, nh * p), h


def apply_mamba2(params: Dict, cfg: ModelConfig, x: torch.Tensor, return_cache: bool = False):
    """SSD forward. x: (B, L, d_model). With ``return_cache``, also the
    decode cache ``{"h": the state after the last chunk (B, heads, head_dim,
    N), "conv": the last K-1 rows of the conv's zero-padded input}``."""
    xin, z, dt, a, b_mat, c_mat, new_tail, _ = _mamba2_inputs(params, cfg, x)
    y, h = _ssd(cfg, xin, dt, a, b_mat, c_mat, params["d_skip"])
    y = _gated_norm(params, cfg, y.to(x.dtype), z)
    out = y @ params["out_proj"].to(x.dtype)
    if return_cache:
        return out, {"h": h, "conv": new_tail}
    return out


def _mamba2_shard(lp: Dict, cfg: ModelConfig, c0: int) -> Dict:
    """A position's Mamba-2 weights, from ``c0`` on: its ``d_l`` channels
    (``wx``'s width: ``wz``, ``wx``, ``norm`` and ``out_proj`` come split
    so) and their ``d_l / head_dim`` heads, which start at ``c0 /
    head_dim`` because the SSD's channels are head-major. ``wdt`` comes
    split over ``ssm_heads`` or whole, and is cut to those heads; so are
    ``a_log``, ``dt_b`` and ``d_skip``, which are whole. The conv runs over
    ``[x | B | C]``: the position's rows of ``conv_w`` and ``conv_b`` are
    its channels' and the last ``2N``, which every position shares."""
    di, p = cfg.d_inner, cfg.ssm_head_dim
    d_l = lp["wx"].shape[-1]
    if d_l % p or c0 % p:
        raise ValueError(f"channels [{c0}, {c0 + d_l}) of {cfg.name}'s Mamba-2 do not hold "
                         f"whole heads of {p}: the heads and the channels must split alike")
    heads = slice(c0 // p, (c0 + d_l) // p)
    wdt = lp["wdt"][:, heads] if lp["wdt"].shape[-1] == cfg.ssm_heads else lp["wdt"]
    return dict(lp, wdt=wdt, a_log=lp["a_log"][heads], dt_b=lp["dt_b"][heads],
                d_skip=lp["d_skip"][heads],
                conv_w=torch.cat([lp["conv_w"][c0:c0 + d_l], lp["conv_w"][di:]]),
                conv_b=torch.cat([lp["conv_b"][c0:c0 + d_l], lp["conv_b"][di:]]))


def mamba2_mesh(lps: Dict[Any, Dict], cfg: ModelConfig, x: Dict[Any, torch.Tensor],
                mesh) -> Dict[Any, torch.Tensor]:
    """Mamba-2 on a mesh, for training. ``lps`` holds each position's block
    weights (its own ``ssm_inner`` channels and ``ssm_heads`` where
    ``model`` splits them, the rest whole), ``x`` each position's normed
    input (B_l, L, d_model).

    Each position runs the SSD on its own heads (:func:`_mamba2_shard`):
    ``wz``/``wx`` are column-parallel, ``wb``/``wc`` whole (B and C are
    every head's). The gated RMSNorm's mean runs over all of ``d_inner``,
    so each position's sum of squares over its channels is summed over
    ``model`` before the ``rsqrt``; ``out_proj`` is row-parallel, its
    partial products summed over ``model``. A whole leaf a position uses
    a slice of (``a_log``, ``dt_b``, ``d_skip``, ``conv_w``, ``conv_b``)
    gets a gradient in that slice only, and the replicas' sum
    (``placed.reduce_replicas``) puts every slice's once. Where ``model``
    splits nothing every position computes the whole block. Returns each
    position's output."""
    from repro_torch.sharding.placed import all_reduce

    di = cfg.d_inner
    mi = mesh.axis_names.index("model") if "model" in mesh.axis_names else None
    split = next(iter(lps.values()))["wx"].shape[-1] < di
    gated, sum_sq, local = {}, {}, {}
    for pos, lp in lps.items():
        d_l = lp["wx"].shape[-1]
        local[pos] = _mamba2_shard(lp, cfg, pos[mi] * d_l if split else 0)
        xin, z, dt, a, b_mat, c_mat, _, _ = _mamba2_inputs(local[pos], cfg, x[pos])
        y, _ = _ssd(cfg, xin, dt, a, b_mat, c_mat, local[pos]["d_skip"])
        gated[pos] = _gate(y.to(x[pos].dtype), z)
        sum_sq[pos] = (gated[pos] * gated[pos]).sum(dim=-1, keepdim=True)
    if split:
        sum_sq = all_reduce(sum_sq, mesh, "model")
    out = {}
    for pos, lp in local.items():
        dtype = x[pos].dtype
        y = _rms_scale(lp, cfg, gated[pos], sum_sq[pos] / di, dtype)
        out[pos] = y @ lp["out_proj"].to(dtype)
    return all_reduce(out, mesh, "model") if split else out


def init_mamba2_cache(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None) -> Dict:
    """Zero state (f32) and conv tail for ``batch`` sequences, on ``device``
    (``None`` = the CUDA device)."""
    dev = resolve_device(device)
    return {
        "h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                         dtype=torch.float32, device=dev),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state),
                            dtype=dtype, device=dev),
    }


def mamba2_decode(params: Dict, cfg: ModelConfig, x: torch.Tensor, cache: Dict):
    """One token. x: (B, 1, d_model). Returns (out, new cache) and leaves
    ``cache`` as it was."""
    dtype = x.dtype
    nh, p = cfg.ssm_heads, cfg.ssm_head_dim
    xin, z, dt, a, b_mat, c_mat, new_tail, _ = _mamba2_inputs(params, cfg, x, cache["conv"])
    xh = xin[:, 0].float().reshape(-1, nh, p)
    da = torch.exp(dt[:, 0] * a)                             # (B, nh)
    bx = (dt[:, 0, :, None] * xh)[..., None] * b_mat[:, 0, None, None, :]
    h = cache["h"] * da[..., None, None] + bx                # (B, nh, p, n)
    y = (h @ c_mat[:, 0, None, :, None])[..., 0]             # "bhpn,bn->bhp"
    y = y + params["d_skip"].float()[:, None] * xh
    y = _gated_norm(params, cfg, y.reshape(x.shape[0], 1, nh * p).to(dtype), z)
    out = y @ params["out_proj"].to(dtype)
    return out, {"h": h, "conv": new_tail}
