"""Batched serving engine: continuous batching over a slotted KV cache.

The port of ``repro.serve.engine`` (the dense, moe, ssm and hybrid
families; the encdec and vlm families need frontend inputs that a prompt
does not carry, in the reference's engine as here), detail for detail:
  * ``max_batch`` slots share one batched cache of ``max_len + 1`` positions —
    the extra position is a *trash slot*: padded prompt tokens write their
    k/v (MLA: latent) there, so bucket-padded prefill never pollutes attention (the causal
    position mask can never reach them: a slot stops before position
    ``max_len - 1``);
  * a prompt's context (all but its last token) is right-padded to a bucket
    length and prefilled in one shot into a batch-1 cache with per-token
    cache destinations (``cache_positions``), then copied into its slot; the
    last prompt token is fed by the slot's first decode step. A moe model
    routes the padded prompt as one group of the bucket's length, pad
    tokens after the prompt's, so they take an expert's capacity only after
    every prompt token;
  * decode runs one step per iteration for all ``max_batch`` slots, idle ones
    included (token 0 at their stale positions), with per-slot positions (a
    moe model routes every slot, the ``max_batch`` rows one group);
    finished slots are refilled from the queue without stalling the others
    (continuous batching).

SSM and hybrid families keep running state rather than positional caches,
so padded prefill is unsound there: as the reference's, the engine takes an
ssm or hybrid prompt's context only at a bucket's exact length and raises
``ValueError`` otherwise (the reference server's own random prompt lengths
are refused so). A one-token prompt has no context and no prefill, so its
slot keeps the state its last occupant and the idle decode steps left
there, as the reference's does.

Every entry of the cache tree (the hybrid's shared-block ``shared``
beside its ``layers``) is prefilled in a one-slot copy and copied into the
slot, as the reference's ``jax.tree.map`` does.

On the card the prefill's attention runs kernel K4 (dense, moe, and the
hybrid's shared block) and its Mamba-1 scan kernel K5 (ssm); the decode
step is plain PyTorch
(``models/attention.py``, ``models/ssm.py``). ``device=None`` means the CUDA
device; ``backend="torch"`` runs the plain lane on any device. Host-clock
times of every prefill and decode step, each ended by a device synchronise,
are kept in ``prefill_ms`` and ``decode_ms``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import Model

__all__ = ["Request", "Engine"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a nested dict of tensors (and of ``rest``,
    trees of the same keys); returns the results in the same tree."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket {buckets[-1]}")


class Engine:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        max_batch: int = 4,
        max_len: int = 256,
        prompt_buckets=(16, 32, 64, 128),
        cache_dtype=torch.float32,
        device=None,
        backend: str = "auto",
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = Model(cfg, backend=backend)
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.buckets = tuple(b for b in prompt_buckets if b <= max_len)
        self.trash = max_len                      # trash slot index
        self.cache = self.model.init_cache(max_batch, max_len + 1, dtype=cache_dtype,
                                           device=self.device)
        self.positions = np.zeros(max_batch, np.int64)   # next write position
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self._pending_token: Dict[int, int] = {}
        self._needs_prefill_pad = cfg.family in ("dense", "moe", "vlm", "encdec")
        self.prefill_ms: List[float] = []
        self.decode_ms: List[float] = []

    # -- public API --------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def run(self, max_iters: int = 10_000) -> List[Request]:
        """Drive until queue + slots drain; returns finished requests."""
        for _ in range(max_iters):
            self._admit()
            if not any(self.slots):
                if not self.queue:
                    break
                continue
            self._decode_once()
        return self.finished

    # -- internals -----------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _admit(self) -> None:
        for slot in range(self.max_batch):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            self._prefill_into(slot, req)
            self.slots[slot] = req

    def _prefill_into(self, slot: int, req: Request) -> None:
        prompt = list(req.prompt)
        if not prompt:
            raise ValueError(f"request {req.uid} has an empty prompt")
        ctx, last = prompt[:-1], prompt[-1]
        if ctx:
            t0 = time.perf_counter()
            n = len(ctx)
            if self._needs_prefill_pad:
                b = _bucket(n, self.buckets)
                toks = np.zeros((1, b), np.int32)
                toks[0, :n] = ctx
                pos = np.arange(b, dtype=np.int32)
                cache_pos = np.where(pos < n, pos, self.trash)[None]
                batch = {
                    "tokens": self._tensor(toks),
                    "positions": self._tensor(pos[None]),
                    "cache_positions": self._tensor(cache_pos),
                }
            else:
                if n not in self.buckets:
                    raise ValueError(
                        f"{self.cfg.family} engine needs bucket-length prompts; "
                        f"got {n}, buckets={self.buckets}"
                    )
                batch = {"tokens": self._tensor(np.asarray(ctx, np.int32)[None])}
            # A one-slot cache of every entry of the tree (the hybrid's
            # ``shared`` beside ``layers``), copied back into the slot.
            small = _tree_map(lambda big: torch.zeros((big.shape[0], 1) + big.shape[2:],
                                                      dtype=big.dtype, device=big.device),
                              self.cache)
            _, small = self.model.prefill(self.params, batch, small)
            _tree_map(lambda big, s: big[:, slot].copy_(s[:, 0]), self.cache, small)
            self._sync()
            self.prefill_ms.append((time.perf_counter() - t0) * 1e3)
        self.positions[slot] = len(ctx)
        self._pending_token[slot] = last

    def _decode_once(self) -> None:
        t0 = time.perf_counter()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        tokens = np.zeros((self.max_batch, 1), np.int32)
        for i in active:
            pend = self._pending_token.pop(i, None)
            if pend is not None:
                tokens[i, 0] = pend
            else:
                tokens[i, 0] = self.slots[i].output[-1]
        idx = self._tensor(self.positions.astype(np.int32))
        logits, self.cache = self.model.decode_step(self.params, self.cache,
                                                    self._tensor(tokens), idx)
        next_tok = torch.argmax(logits[:, 0, :], dim=-1).cpu().numpy()
        self.decode_ms.append((time.perf_counter() - t0) * 1e3)
        for i in active:
            req = self.slots[i]
            tok = int(next_tok[i])
            req.output.append(tok)
            self.positions[i] += 1
            hit_eos = req.eos_id is not None and tok == req.eos_id
            if len(req.output) >= req.max_new_tokens or hit_eos or self.positions[i] >= self.max_len - 1:
                req.done = True
                self.finished.append(req)
                self.slots[i] = None
