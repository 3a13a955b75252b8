"""Public model API: init / forward / loss / cache / prefill / decode for
every LM family (dense with GQA or MLA, moe, ssm, hybrid, encdec, vlm), and
:func:`carry_params`, which takes the reference's weights.

The port of ``repro.models.model``: ``Model`` (its training half too:
``cast_params``, ``loss_fn``) and :func:`cross_entropy`. Parameters are a
nested dict of tensors under the reference's names, with the stacked
leading layer axis, so the reference's tree carries across name for name.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.layers import Spec, init_tree, map_specs, torch_dtype
from repro_torch.tree import tree_map

__all__ = ["Model", "carry_params", "cross_entropy", "xent_sums"]


def xent_sums(logits: torch.Tensor, labels: torch.Tensor,
              weights: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the weighted token cross-entropies, sum of the weights), in
    f32. The label logit is taken with a masked sum over the vocabulary,
    as the reference takes it (its vocab-sharded form), not with a gather."""
    logits = logits.float()
    log_z = torch.logsumexp(logits, dim=-1)
    iota = torch.arange(logits.shape[-1], device=logits.device)
    ll = torch.where(iota == labels[..., None].long(), logits, 0.0).sum(dim=-1)
    xent = log_z - ll
    weights = torch.ones_like(xent) if weights is None else weights.float()
    return (xent * weights).sum(), weights.sum()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean masked token cross-entropy, in f32 (:func:`xent_sums`' ratio)."""
    num, den = xent_sums(logits, labels, weights)
    return num / torch.clamp(den, min=1e-6)


class Model:
    """Thin functional wrapper binding a ModelConfig to the layer stack.

    ``backend`` picks the kernel lane of every call: ``auto`` (kernel K4
    for every prefill attention, the encoder's and the cross-attention
    included, and K5 for an ssm model's scan on CUDA tensors, their plain
    versions on CPU ones), ``cuda`` or ``torch`` (the plain versions on any
    device).
    """

    def __init__(self, cfg: ModelConfig, *, backend: str = "auto"):
        T.check_family(cfg)
        self.cfg = cfg
        self.backend = backend

    # -- parameters ---------------------------------------------------------
    def param_specs(self):
        return T.model_param_specs(self.cfg)

    def init(self, seed: int = 0, *, dtype=torch.float32, device=None):
        """Random weights drawn on ``device`` (``None`` = the CUDA device)
        from ``seed``; the same in every process."""
        return init_tree(self.param_specs(), seed, dtype=dtype, device=resolve_device(device))

    def logical_axes(self):
        """The parameter tree with each leaf's logical axes (a tuple of
        names), which the sharding rules map onto a mesh."""
        return map_specs(lambda _p, s: tuple(s.axes), self.param_specs())

    def abstract_params(self, dtype=torch.float32):
        """The parameter tree as ``meta`` tensors: shapes and dtype, no memory."""
        meta = torch.device("meta")
        return map_specs(lambda _p, s: torch.empty(s.shape, dtype=dtype, device=meta),
                         self.param_specs())

    def param_count(self) -> int:
        total = []
        map_specs(lambda _p, s: total.append(math.prod(s.shape)), self.param_specs())
        return int(sum(total))

    # -- forward / loss -------------------------------------------------------
    def forward(self, params, batch: Dict):
        return T.forward(params, self.cfg, batch, backend=self.backend)

    def cast_params(self, params):
        """Mixed precision: one cast of every f32 leaf to ``cfg.dtype`` up
        front, so the products run in it; autograd carries the gradients
        back to the f32 tree (an f32 config casts nothing)."""
        dtype = torch_dtype(self.cfg.dtype)
        return tree_map(lambda p: p.to(dtype) if p.dtype == torch.float32 else p, params)

    def loss_fn(self, params, batch: Dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, metrics): the cross-entropy of the cast model's logits
        against ``batch["labels"]`` (weighted by ``loss_weights`` where the
        batch has them), plus each auxiliary loss of the forward (a moe
        model's ``moe_aux`` and ``moe_z``), as the reference adds them.
        ``loss`` carries the graph; the metrics are detached."""
        logits, aux = self.forward(self.cast_params(params), batch)
        xent = cross_entropy(logits, batch["labels"], batch.get("loss_weights"))
        loss = xent
        metrics = {"xent": xent.detach()}
        for k, v in aux.items():
            loss = loss + v
            metrics[k] = v.detach()
        metrics["loss"] = loss.detach()
        return loss, metrics

    def mesh_loss_fn(self, params, batch: Dict, mesh) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """:meth:`loss_fn` on a mesh. ``params`` and ``batch`` hold
        :class:`~repro_torch.sharding.placed.Placed` leaves (``batch`` split
        over ``(pod, data)``); each batch shard's forward runs on its
        positions (``transformer.mesh_forward``, every family: FSDP
        gathers, the cast to ``cfg.dtype``, tensor-parallel attention on
        K4, the encdec model's encoder and cross-attention on K4 too, the
        MLP, expert-parallel MoE, Mamba-1 on K5, Mamba-2 on each position's
        heads). A VLM's labels and ``loss_weights`` cover its patches, which
        weigh 0. The cross-entropy is the sum
        of the shards' weighted cross-entropies (in batch shard order, on
        the mesh's lead device) over the sum of their weights, which is
        :func:`cross_entropy` of the whole batch; each auxiliary loss of
        the forward (a moe model's ``moe_aux`` and ``moe_z``, means over
        the microbatch's routing groups) is added to it once, as
        :meth:`loss_fn` adds them."""
        logits, aux = T.mesh_forward(params, self.cfg, batch, mesh, backend=self.backend)
        num, den = [], []
        for pos, lg in logits.items():
            w = batch.get("loss_weights")
            n, d = xent_sums(lg, batch["labels"].local(pos), None if w is None else w.local(pos))
            num.append(n.to(mesh.lead))
            den.append(d.to(mesh.lead))
        total, weight = num[0], den[0]
        for n, d in zip(num[1:], den[1:]):
            total, weight = total + n, weight + d
        xent = total / torch.clamp(weight, min=1e-6)
        loss = xent
        metrics = {"xent": xent.detach()}
        for k, v in aux.items():
            loss = loss + v
            metrics[k] = v.detach()
        metrics["loss"] = loss.detach()
        return loss, metrics

    # -- serving --------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
        return T.init_cache(self.cfg, batch, max_len, dtype, device)

    def prefill(self, params, batch: Dict, cache: Dict):
        return T.prefill(params, self.cfg, batch, cache, backend=self.backend)

    def decode_step(self, params, cache: Dict, tokens: torch.Tensor, index):
        return T.decode_step(params, self.cfg, cache, tokens, index, backend=self.backend)


def carry_params(tree: Any, cfg: ModelConfig, device=None) -> Dict:
    """The reference's parameter tree, as numpy arrays (``jax.tree.map(
    np.asarray, params)``), as the port's: the same names, shapes and stacked
    layer axis (the hybrid's ``shared`` block, an encdec model's ``encoder``
    stack and its layers' ``ln_x`` and ``cross`` among them), on ``device``
    (``None`` = the CUDA device). Raises when a name or a shape differs from
    the port's specs."""
    dev = resolve_device(device)

    def leaf(path: str, spec: Spec) -> torch.Tensor:
        node = tree
        for key in path.split("/"):
            if not isinstance(node, dict) or key not in node:
                raise KeyError(f"the carried tree has no parameter {path!r}")
            node = node[key]
        arr = np.asarray(node)
        if arr.shape != tuple(spec.shape):
            raise ValueError(f"{path}: carried shape {arr.shape} != spec {tuple(spec.shape)}")
        return torch.tensor(arr, device=dev)   # a copy: the source may be read-only

    out = map_specs(leaf, Model(cfg).param_specs())
    extra = _paths(tree) - _paths(out)
    if extra:
        raise KeyError(f"the carried tree has parameters the port does not: {sorted(extra)}")
    return out


def _paths(tree: Any, prefix: str = "") -> set:
    if not isinstance(tree, dict):
        return {prefix}
    return set().union(*(_paths(v, f"{prefix}/{k}" if prefix else k) for k, v in tree.items()))
