"""Foundational model layers and the parameter-spec system.

The port of ``repro.models.layers``. Parameters are declared as
``Spec(shape, logical_axes, init)`` trees (nested dicts), and the same
declaration drives initialization, the parameter count and the sharding:
``Model.logical_axes()`` reads the axes, which the rules of
``repro_torch.sharding`` map onto a mesh.

:func:`init_tree` differs from the reference on purpose: the reference folds
Python's per-process-salted ``hash`` of a leaf's path into its key, so its
weights change from process to process. The port seeds each leaf from
``zlib.crc32`` of the seed and its path on an explicit ``torch.Generator`` on the target
device: the same seed gives the same weights in every process, and a
full-size model is drawn on the card without a copy from the host. The
two packages are compared through ``models.model.carry_params``, never
through their initializers.
"""
from __future__ import annotations

import math
import zlib
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

__all__ = [
    "Spec",
    "map_specs",
    "init_tree",
    "init_leaf",
    "stack_specs",
    "torch_dtype",
    "norm_params",
    "apply_norm",
    "mlp_params",
    "apply_mlp",
    "rope_frequencies",
    "apply_rope",
    "embed_params",
]


class Spec(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "fan_in"        # fan_in | normal | zeros | ones | mamba1_alog | mamba2_alog | dt_bias
    scale: float = 1.0


def map_specs(fn: Callable[[str, Spec], Any], specs: Any, prefix: str = "") -> Any:
    """Apply ``fn(path, spec)`` to every leaf of a nested-dict Spec tree;
    ``path`` joins the dict keys with ``/`` as the reference's does."""
    if isinstance(specs, Spec):
        return fn(prefix, specs)
    return {k: map_specs(fn, v, f"{prefix}/{k}" if prefix else str(k))
            for k, v in specs.items()}


def torch_dtype(name: str) -> torch.dtype:
    """``"float32"``/``"bfloat16"``/... (a config's ``dtype``) as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _init_leaf(spec: Spec, gen: torch.Generator, dtype, device) -> torch.Tensor:
    shape = spec.shape
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if spec.init == "mamba1_alog":
        # A = -exp(A_log); A_log[d, n] = log(1..N)
        n = shape[-1]
        row = torch.log(torch.arange(1, n + 1, dtype=dtype, device=device))
        return row.expand(shape).contiguous()
    if spec.init == "mamba2_alog":
        # A in [-16, -1]: A_log ~ log(uniform[1, 16])
        u = torch.rand(shape, generator=gen, dtype=dtype, device=device)
        return torch.log(u * 15.0 + 1.0)
    if spec.init == "dt_bias":
        # softplus(dt_bias) ~ uniform in [1e-3, 1e-1] (mamba init)
        u = torch.rand(shape, generator=gen, dtype=dtype, device=device)
        dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
        return dt + torch.log(-torch.expm1(-dt))
    if spec.init == "normal":
        std = spec.scale * 0.02
    elif spec.init == "fan_in":
        std = spec.scale / math.sqrt(max(1, shape[0]))
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    # Scaled in place: a full-size leaf (falcon-mamba-7b's stacked in_proj is
    # 17.2 GB in f32) is drawn once, with no second copy for the product.
    return torch.randn(shape, generator=gen, dtype=dtype, device=device).mul_(std)


def init_leaf(path: str, spec: Spec, seed: int = 0, *, dtype=torch.float32,
              device: "torch.device | str" = "cpu") -> torch.Tensor:
    """One leaf of :func:`init_tree`, drawn on ``device`` from a
    ``torch.Generator`` seeded with the crc32 of ``seed`` and ``path``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    # crc32 of "seed/path": 32 bits, all the CPU generator's seed keeps.
    gen.manual_seed(zlib.crc32(f"{seed}/{path}".encode()))
    return _init_leaf(spec, gen, dtype, device)


def init_tree(specs: Any, seed: int = 0, *, dtype=torch.float32,
              device: "torch.device | str" = "cpu") -> Any:
    """Materialize a Spec tree on ``device``: each leaf is drawn by
    :func:`init_leaf` from its path, so it is the same in every process."""
    return map_specs(lambda path, spec: init_leaf(path, spec, seed, dtype=dtype, device=device),
                     specs)


def stack_specs(specs: Any, n: int, axis_name: Optional[str] = "layers") -> Any:
    return map_specs(lambda _p, s: Spec((n,) + s.shape, (axis_name,) + s.axes, s.init, s.scale),
                     specs)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_params(cfg: ModelConfig) -> Dict[str, Spec]:
    if cfg.norm_type == "layernorm_np":  # OLMo: non-parametric
        return {}
    if cfg.norm_type == "layernorm":
        return {
            "scale": Spec((cfg.d_model,), ("embed",), "ones"),
            "bias": Spec((cfg.d_model,), ("embed",), "zeros"),
        }
    return {"scale": Spec((cfg.d_model,), ("embed",), "ones")}


def apply_norm(params: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    if cfg.norm_type in ("layernorm", "layernorm_np"):
        x = x - x.mean(dim=-1, keepdim=True)
        x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + cfg.norm_eps)
        if cfg.norm_type == "layernorm":
            x = x * params["scale"].float() + params["bias"].float()
    else:  # rmsnorm
        x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + cfg.norm_eps)
        x = x * params["scale"].float()
    return x.to(dtype)


# ---------------------------------------------------------------------------
# Dense MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------

def mlp_params(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, Spec]:
    d_ff = d_ff or cfg.d_ff
    p = {
        "w_up": Spec((cfg.d_model, d_ff), ("embed", "mlp")),
        "w_down": Spec((d_ff, cfg.d_model), ("mlp", "embed")),
    }
    if cfg.mlp_type == "swiglu":
        p["w_gate"] = Spec((cfg.d_model, d_ff), ("embed", "mlp"))
    return p


def apply_mlp(params: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    up = x @ params["w_up"].to(dtype)
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ params["w_gate"].to(dtype)) * up
    else:
        h = F.gelu(up, approximate="tanh")   # jax.nn.gelu's default
    return h @ params["w_down"].to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return (1.0 / theta) ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D) (or (B, S, D) for a shared rope head), positions (B, S)."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[:, :, None, :]
    d = x.shape[-1]
    freqs = torch.from_numpy(rope_frequencies(d, theta)).to(x.device)          # (d/2,)
    angles = positions.float()[:, :, None, None] * freqs                      # (B,S,1,d/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    return out[:, :, 0, :] if squeeze else out


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

def embed_params(cfg: ModelConfig) -> Dict[str, Spec]:
    p = {"embedding": Spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), "normal")}
    if not cfg.tie_embeddings:
        p["lm_head"] = Spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return p
