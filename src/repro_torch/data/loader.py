"""Sharded, prefetching, checkpointable data loader: the port of
``repro.data.loader``.

The loader is a thin deterministic pipeline over ``data.synthetic``:
  * batches are a pure function of (seed, step), so restoring ``state()``
    resumes the exact stream (what a fault-tolerant restart needs);
  * a background thread prefetches ``prefetch`` steps ahead and makes the
    numpy batches; ``__next__`` places the one it hands out on ``device``
    (the CUDA device unless the caller names another) or, with ``mesh=``,
    onto the mesh: each array split by its logical axes under the
    ``batch`` rule (``(pod, data)``, else ``data``), as the reference's
    ``batch_shardings`` places it;
  * after a ``restore`` the stale prefetches are dropped.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import image_batch, lm_batch
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.sharding.placed import place
from repro_torch.sharding.rules import NamedSharding, logical_to_spec

__all__ = ["DataLoader", "batch_shardings"]

_BATCH_AXES = {
    "tokens": ("batch", None),
    "labels": ("batch", None),
    "loss_weights": ("batch", None),
    "positions": ("batch", None),
    "patch_embeds": ("batch", None, None),
    "enc_embeds": ("batch", None, None),
    "images": ("batch", "height", "width"),
}


def batch_shardings(batch: Dict, mesh) -> Optional[Dict[str, NamedSharding]]:
    """Where each array of ``batch`` (arrays or tensors by name) goes on
    ``mesh``: its logical axes under the default rules, degraded where the
    batch does not divide. None without a mesh."""
    if mesh is None:
        return None
    return {k: NamedSharding(mesh, logical_to_spec(_BATCH_AXES[k], mesh, tuple(v.shape)))
            for k, v in batch.items()}


class DataLoader:
    """Deterministic prefetching loader; ``state()``/``restore()`` round-trip.

    ``device``: where ``__next__`` puts the batch's tensors (``None`` = the
    CUDA device; raises at construction where there is none). ``mesh``:
    place each batch on it instead (:func:`batch_shardings`); its lead
    device stands for ``device``."""

    def __init__(
        self,
        cfg: ModelConfig,
        batch: int,
        seq_len: int = 0,
        *,
        mesh=None,
        seed: int = 0,
        prefetch: int = 2,
        start_step: int = 0,
        device=None,
    ):
        self.cfg, self.batch, self.seq_len = cfg, batch, seq_len
        self.seed = seed
        self.mesh = mesh
        self.device = resolve_device(mesh.lead if mesh is not None else device)
        self._step = start_step
        self._prefetch = max(1, prefetch)
        self._q: "queue.Queue" = queue.Queue(maxsize=self._prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- determinism / checkpointing -----------------------------------------
    def state(self) -> Dict:
        return {"step": self._step, "seed": self.seed}

    def restore(self, state: Dict) -> None:
        self._drain()
        self._step = int(state["step"])
        self.seed = int(state["seed"])

    # -- production ------------------------------------------------------------
    def _make(self, step: int) -> Dict[str, np.ndarray]:
        if self.cfg.family == "image":
            return image_batch(self.cfg, self.batch, seed=self.seed, step=step)
        return lm_batch(self.cfg, self.batch, self.seq_len, seed=self.seed, step=step)

    def _place(self, host_batch: Dict[str, np.ndarray]) -> Dict:
        tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in host_batch.items()}
        if self.mesh is not None:
            shardings = batch_shardings(tensors, self.mesh)
            return {k: place(v, shardings[k]) for k, v in tensors.items()}
        return {k: v.to(self.device) for k, v in tensors.items()}

    def _worker(self, step: int):
        while not self._stop.is_set():
            try:
                self._q.put((step, self._make(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def _drain(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        while not self._q.empty():
            self._q.get_nowait()
        self._stop.clear()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._worker, args=(self._step,),
                                            daemon=True)
            self._thread.start()
        while True:
            step, host_batch = self._q.get()
            if step == self._step:                 # drop stale prefetches post-restore
                break
        self._step += 1
        return self._place(host_batch)

    def close(self):
        self._drain()
