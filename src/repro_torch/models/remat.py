"""Activation rematerialisation of the training forward: the port of the
reference's ``_maybe_remat`` (``repro.models.transformer``), which wraps
each scanned layer in ``jax.checkpoint``.

A unit is what the reference checkpoints: one block of
``transformer.block_plan`` for the dense, moe, vlm, encdec (its decoder
layer with its cross-attention's k/v projection) and ssm stacks; each
encoder layer; one whole hybrid group, ``attn_every`` Mamba-2 layers and
then the shared block. :func:`unit` runs one through
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``; the trainer's
``torch.autograd.grad`` needs the non-reentrant variant. What a config's
``remat`` and ``remat_policy`` keep of a unit for the backward:

* ``"minimal"`` (the reference's ``nothing_saveable``): only the unit's
  inputs. The backward runs the unit's forward again, whole (no early
  stop: a unit's trailing all-reduce on a mesh runs again too, so every
  collective and launch of a unit runs twice a step, on any torch), kernels
  K4 and K5 included, and differentiates that.
* ``"dots"`` (``dots_with_no_batch_dims_saveable``): selective
  checkpointing (``create_selective_checkpoint_contexts``). The outputs
  of ``aten.mm`` and ``aten.addmm`` are kept: a (B, S, d) activation
  times a 2-D weight reaches ``aten.mm``. Everything else is recomputed,
  the batched products (``aten.bmm``: the MoE's expert einsums, the plain
  attention) and the K4 and K5 launches among them.
* ``"none"``, or ``remat=False``: nothing is wrapped, and autograd keeps
  what each operation saves.

Without autograd (grad disabled, or no input of the unit that requires
grad: prefill, decode, evaluation) a unit runs as it is, under any policy.

:func:`measure_keep` measures what a forward keeps for its backward, and
:func:`tally_keep` lets a caller (the dry run) count it from the units'
arguments instead.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    set_checkpoint_early_stop)

__all__ = ["POLICIES", "SAVED_OPS", "policy", "forward_runs", "unit", "measure_keep",
           "tally_keep", "KeepTally"]

POLICIES = ("none", "minimal", "dots")
SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)   # kept under "dots"


def policy(cfg) -> str:
    """The policy that ``cfg`` trains under: ``"none"`` where ``remat`` is
    off, else ``remat_policy``. Raises for a policy name it does not know."""
    if cfg.remat_policy not in POLICIES:
        raise ValueError(f"remat_policy={cfg.remat_policy!r}; known: {POLICIES}")
    return cfg.remat_policy if cfg.remat else "none"


def forward_runs(cfg) -> int:
    """How often a training step runs each unit's forward, K4 and K5 in it:
    twice where ``cfg`` rematerialises (the recompute in the backward),
    else once."""
    return 1 if policy(cfg) == "none" else 2


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class KeepTally:
    """What the units of a forward keep, counted from their arguments:
    ``inputs`` maps a storage key to (bytes, tensor) for every tensor a
    unit takes (each storage once), ``saved_bytes`` sums the outputs of the
    ``dots`` policy's kept products, and ``units`` counts the units."""

    def __init__(self):
        self.inputs: Dict[int, Tuple[int, torch.Tensor]] = {}
        self.saved_bytes = 0
        self.units = 0


_TALLIES: List[KeepTally] = []


@contextlib.contextmanager
def tally_keep() -> Iterator[KeepTally]:
    """Count, while the block runs, what every checkpointed unit keeps."""
    tally = KeepTally()
    _TALLIES.append(tally)
    try:
        yield tally
    finally:
        _TALLIES.remove(tally)


def _dots_policy(ctx, op, *args, **kwargs):
    if op not in SAVED_OPS:
        return CheckpointPolicy.PREFER_RECOMPUTE
    if not ctx.is_recompute and _TALLIES:
        a, b = (args[0], args[1]) if op is SAVED_OPS[0] else (args[1], args[2])
        for tally in _TALLIES:
            tally.saved_bytes += a.shape[0] * b.shape[1] * a.element_size()
    return CheckpointPolicy.MUST_SAVE


_dots_contexts = functools.partial(create_selective_checkpoint_contexts, _dots_policy)


def unit(fn: Callable, cfg, *args):
    """``fn(*args)``, one unit of the training forward, rematerialised as
    ``cfg`` says where autograd records it. Every tensor the unit reads
    must come in ``args`` (nested dicts, lists and tuples of tensors are
    fine), so that the keep is counted whole."""
    pol = policy(cfg)
    if pol == "none" or not torch.is_grad_enabled() or not any(
            t.requires_grad for t in _tensors(args)):
        return fn(*args)
    for tally in _TALLIES:
        tally.units += 1
        for t in _tensors(args):
            tally.inputs.setdefault(t.untyped_storage()._cdata,
                                    (t.untyped_storage().nbytes(), t))
    kw = {"context_fn": _dots_contexts} if pol == "dots" else {}
    with set_checkpoint_early_stop(False):       # the whole unit again, its last op included
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)


class _LiveStorages(TorchDispatchMode):
    """Records the storage of every operation's output that is neither an
    earlier output's (an in-place result, a view) nor one that an
    operation read without having made it (a weight, the batch, and the
    views of them). Storages are keyed by address and held weakly: one
    freed during the call may hand its address to a new one, so an entry
    whose storage has expired is forgotten."""

    def __init__(self):
        super().__init__()
        self.external: Dict[int, StorageWeakRef] = {}
        self.made: Dict[int, Tuple[StorageWeakRef, int]] = {}

    @staticmethod
    def _alive(table: dict, key: int) -> bool:
        rec = table.get(key)
        ref = rec[0] if isinstance(rec, tuple) else rec
        if ref is not None and ref.expired():
            del table[key]
            return False
        return ref is not None

    def _known(self, key: int) -> bool:
        return self._alive(self.made, key) or self._alive(self.external, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in _tensors((args, kwargs)):
            s = t.untyped_storage()
            if not self._known(s._cdata):
                self.external[s._cdata] = StorageWeakRef(s)
        out = func(*args, **kwargs)
        for t in _tensors(out):
            s = t.untyped_storage()
            if not self._known(s._cdata):
                self.made[s._cdata] = (StorageWeakRef(s), s.nbytes())
        return out


def measure_keep(fn: Callable, *args, **kwargs) -> Tuple[Any, int]:
    """(``fn(*args, **kwargs)``, the bytes its operations made that are
    still alive when it returns): run a forward that returns its loss,
    and this is what the forward keeps for the backward (and the loss and
    metrics themselves, a few scalars). Each storage counts once; tensors
    that existed before the call (the weights, the batch) and their views
    do not count."""
    mode = _LiveStorages()
    with mode:
        out = fn(*args, **kwargs)
    return out, sum(n for ref, n in mode.made.values() if not ref.expired())
