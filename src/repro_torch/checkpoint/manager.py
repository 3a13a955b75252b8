"""Fault-tolerant checkpointing: atomic, retained, resumable, async-capable.
The port of ``repro.checkpoint.manager``, in the reference's layout, so a
checkpoint written by either package restores in the other:

    <dir>/step_<N:010d>/arrays.npz + meta.json

``arrays.npz`` holds one array per leaf of the state, keyed by the leaf's
path joined with ``|`` (``.params|layers|attn|wq``, ``.opt|.mu|...``: a
NamedTuple field as ``.name``, as ``jax.tree_util`` prints it). A
checkpoint is written to ``step_<N>.tmp`` and published with ``os.rename``,
so readers never see a partial one. The newest ``keep`` are retained.
``latest_step`` / ``restore`` implement auto-resume; the data loader's
state rides in ``meta``. A leaf placed on a mesh
(:class:`~repro_torch.sharding.placed.Placed`) is saved whole, gathered
from its shards, so the file does not depend on the mesh. ``restore`` puts
the arrays on a device in the template's dtypes or, given ``shardings``,
places each onto a mesh, which may differ from the one that saved it (the
reference's elastic restore).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.sharding.placed import Placed, gather, place
from repro_torch.tree import leaves, leaves_with_path, tree_map, unflatten

__all__ = ["CheckpointManager"]

_SEP = "|"


def _to_numpy(leaf: Any) -> np.ndarray:
    """A tensor's host copy (never a view of a CPU tensor's memory, which
    the caller may go on changing), a placed leaf gathered whole; an array
    as it is."""
    if isinstance(leaf, Placed):
        return gather(leaf, "cpu").numpy()
    if isinstance(leaf, torch.Tensor):
        return np.array(leaf.detach().cpu())
    return np.asarray(leaf)


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {_SEP.join(path): _to_numpy(leaf) for path, leaf in leaves_with_path(tree)}


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- write -----------------------------------------------------------------
    def save(self, step: int, state: Any, meta: Optional[Dict] = None) -> None:
        """Write ``state`` as step ``step``. With ``async_save`` the arrays
        are copied to the host first (so the caller may go on changing the
        device tensors) and written by a background thread; a second save
        waits for the first."""
        if self.async_save:
            self.wait()
            host_state = tree_map(_to_numpy, state)
            self._thread = threading.Thread(
                target=self._save_sync, args=(step, host_state, meta), daemon=True
            )
            self._thread.start()
        else:
            self._save_sync(step, state, meta)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _save_sync(self, step: int, state: Any, meta: Optional[Dict]) -> None:
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **_flatten(state))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "meta": meta or {}}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"), ignore_errors=True)

    # -- read ------------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None, shardings: Any = None,
                device=None) -> Tuple[Any, Dict]:
        """Restore into the structure of ``template`` (a tree whose leaves
        are tensors, or anything with ``dtype``): each array is checked
        against the leaf's shape and put on ``device`` (``None`` = the CUDA
        device) in the leaf's torch dtype or, with ``shardings`` (a tree of
        ``NamedSharding`` of the template's structure), placed onto its
        mesh. Returns (state, meta.json)."""
        dev = resolve_device(device) if shardings is None else None
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)

        restored = []
        where = leaves(shardings) if shardings is not None else None
        for i, (path_t, leaf) in enumerate(leaves_with_path(template)):
            key = _SEP.join(path_t)
            if key not in flat:
                raise KeyError(f"checkpoint missing {key!r}")
            arr = flat[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != template "
                                 f"{tuple(leaf.shape)}")
            arr = np.require(arr, requirements="C")        # keeps a 0-d array 0-d
            t = torch.from_numpy(arr).to(leaf.dtype)
            restored.append(place(t, where[i]) if where is not None else t.to(dev))
        return unflatten(template, restored), meta
