"""Training loop: train step, grad accumulation, ZeRO-1, checkpoint/restart,
straggler monitoring. The port of ``repro.train.loop``, on one device or
on a mesh.

``Trainer`` owns the step; ``fit`` drives it with the fault-tolerant
runner's policy, so injected or real step failures trigger retry, then
checkpoint-restore. One step on one device: ``Model.loss_fn`` (the f32
master weights cast to ``cfg.dtype``, the forward on the model's lane:
kernel K4 for the attention and K5 for a Mamba-1 scan on a CUDA tensor,
through their autograd Functions), ``torch.autograd.grad`` back to the
f32 tree, the microbatches' gradients summed in f32 and divided by their
count, then ``adamw.update`` at the ``warmup_cosine`` learning rate of the
step.

On a mesh (``mesh=``, a ``runtime.elastic.Mesh``; every family: dense
with GQA or MLA, moe, ssm, hybrid, encdec and vlm) the state is placed by
the train rules (``state_shardings``:
TP over ``model``, FSDP over ``data``, ZeRO-1 moments), each leaf a
:class:`~repro_torch.sharding.placed.Placed` whose shards live on their
positions' devices; the scalars (the step, AdamW's count) stay on the
mesh's lead device. A step: each microbatch placed by the ``batch`` rule,
``Model.mesh_loss_fn`` (every batch shard's forward on its positions, K4
on each position's own heads, the encoder's and the cross-attention's
too, K5 on its own Mamba-1 channels, Mamba-2 on its own heads, the MoE's
experts split over ``model``; a moe model's aux losses added once),
``torch.autograd.grad`` back to every
stored shard (the all-gathers' backward reduce-scatters the gradients),
the replicas' gradients all-reduced (``placed.reduce_replicas``: over
``pod``, and over ``model`` for the norm scales), then ``adamw.update``
on the placed state. The reference jits the step with the same
shardings and lets GSPMD insert the collectives; the port calls them.

The reference donates the state to the step; the port keeps the old state
until the step returns (a retried step reuses it). The forward of either
step rematerialises as the config's ``remat`` and ``remat_policy`` say
(``models/remat.py``: a unit's inputs kept and its forward run again in
the backward, or, under ``dots``, its products with a weight kept too),
as the reference's ``jax.checkpoint`` does. ``TrainConfig`` leaves out the
reference's ``checkpoint_dir`` and ``keep_checkpoints``, which nothing
there reads: the ``CheckpointManager`` given to ``fit`` holds the
directory and the retention.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.loader import DataLoader, batch_shardings
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import Model
from repro_torch.models.layers import init_leaf, map_specs
from repro_torch.optim import adamw
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime.fault import FaultPolicy, StepFailure
from repro_torch.runtime.monitor import StepMonitor
from repro_torch.sharding.partition import shardings_for_tree
from repro_torch.sharding.placed import Placed, gather, place, reduce_replicas, zeros
from repro_torch.tree import leaves, tree_map, unflatten

log = logging.getLogger("repro_torch.train")

__all__ = ["TrainConfig", "TrainState", "Trainer"]


@dataclasses.dataclass
class TrainConfig:
    batch: int = 8
    seq_len: int = 128
    steps: int = 100
    microbatches: int = 1
    peak_lr: float = 3e-4
    warmup_steps: int = 20
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    seed: int = 0
    checkpoint_every: int = 50
    log_every: int = 10


class TrainState(NamedTuple):
    step: torch.Tensor        # int32 scalar
    params: Any               # f32 master weights
    opt: adamw.AdamWState


def _add(a, b):
    if isinstance(a, Placed):
        return Placed(a.mesh, a.spec, a.shape, {p: t + b.local(p) for p, t in a.shards.items()})
    return a + b


def _at(tree: Any, path: str) -> Any:
    for key in path.split("/"):
        tree = tree[key]
    return tree


class Trainer:
    """``model_cfg`` trained by ``train_cfg`` on ``device`` (``None`` = the
    CUDA device), or on ``mesh`` (a ``runtime.elastic.Mesh``; its lead
    device then stands for ``device``). A mesh takes every LM family. After
    ``fit``, ``self.state`` is the last state."""

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig, *, mesh=None,
                 device=None):
        self.cfg = model_cfg
        self.tc = train_cfg
        self.mesh = mesh
        if mesh is not None:
            device = mesh.lead
        self.device = resolve_device(device)
        self.model = Model(model_cfg)
        self.monitor = StepMonitor()
        self.state: Optional[TrainState] = None

    # -- sharding -----------------------------------------------------------
    def state_axes(self) -> TrainState:
        """The state's logical axes: the params', and the moments' with
        ZeRO-1 on a mesh."""
        p_axes = self.model.logical_axes()
        if self.mesh is not None:
            o_axes = adamw.opt_state_axes(p_axes, self.model.abstract_params(), self.mesh)
        else:
            o_axes = adamw.AdamWState(count=(), mu=p_axes, nu=p_axes)
        return TrainState(step=(), params=p_axes, opt=o_axes)

    def state_shardings(self) -> Optional[TrainState]:
        """Where each leaf of the state lives on the mesh (train rules, with
        divisibility degradation); None without a mesh."""
        if self.mesh is None:
            return None
        return shardings_for_tree(self.state_axes(), self.mesh, self.abstract_state(),
                                  rules="train")

    # -- the step ---------------------------------------------------------------
    def lr(self, step: int) -> float:
        tc = self.tc
        return warmup_cosine(step, peak_lr=tc.peak_lr, warmup_steps=tc.warmup_steps,
                             total_steps=tc.steps)

    def grads_of(self, params, batch: Dict) -> Tuple[Any, Dict[str, torch.Tensor]]:
        """(gradients of ``loss_fn`` w.r.t. the f32 tree, metrics)."""
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        loss, metrics = self.model.loss_fn(unflatten(params, flat), batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, flat)]
        return unflatten(params, grads), metrics

    def mesh_grads_of(self, params, batch: Dict) -> Tuple[Any, Dict[str, torch.Tensor]]:
        """``grads_of`` on the mesh: the gradients of ``mesh_loss_fn`` with
        respect to every stored shard (placed as the params), the
        replicas' summed (``reduce_replicas``)."""
        req = tree_map(lambda p: p.map(lambda t: t.detach().requires_grad_(True)), params)
        loss, metrics = self.model.mesh_loss_fn(req, batch, self.mesh)
        placed = leaves(req)
        grads = iter(torch.autograd.grad(
            loss, [t for leaf in placed for t in leaf.shards.values()], allow_unused=True))
        out = []
        for leaf in placed:
            shards = {}
            for pos, t in leaf.shards.items():
                g = next(grads)
                shards[pos] = torch.zeros_like(t) if g is None else g
            out.append(reduce_replicas(Placed(leaf.mesh, leaf.spec, leaf.shape, shards)))
        return unflatten(params, out), metrics

    def _microbatches(self, batch: Dict) -> List[Dict]:
        """The step's microbatches (rows ``[i*B/n, (i+1)*B/n)`` of the
        batch, as the reference's reshape takes them), each placed on the
        mesh by the ``batch`` rule; a placed batch of one microbatch is
        used as it is."""
        n = self.tc.microbatches
        if self.mesh is None:
            if n == 1:
                return [batch]
            return [{k: v.reshape((n, -1) + tuple(v.shape[1:]))[i] for k, v in batch.items()}
                    for i in range(n)]
        if n == 1 and all(isinstance(v, Placed) for v in batch.values()):
            return [batch]
        whole = {k: gather(v) for k, v in batch.items()}
        out = []
        for i in range(n):
            one = {k: v.reshape((n, -1) + tuple(v.shape[1:]))[i] for k, v in whole.items()}
            out.append({k: place(v, sh) for (k, v), sh in
                        zip(one.items(), batch_shardings(one, self.mesh).values())})
        return out

    def step_fn(self, state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        tc = self.tc
        lr = self.lr(int(state.step))               # read before the step is queued
        grads_of = self.grads_of if self.mesh is None else self.mesh_grads_of
        parts = self._microbatches(batch)
        if len(parts) > 1:
            n = len(parts)
            grads, per_mb = None, []
            for one in parts:
                g, metrics = grads_of(state.params, one)
                grads = g if grads is None else tree_map(_add, grads, g)   # f32 sums
                per_mb.append(metrics)
            grads = tree_map(lambda g: g.map(lambda t: t / n) if isinstance(g, Placed)
                             else g / n, grads)
            metrics = {k: torch.stack([m[k] for m in per_mb]).mean() for k in per_mb[0]}
        else:
            grads, metrics = grads_of(state.params, parts[0])

        new_params, new_opt, stats = adamw.update(
            grads, state.opt, state.params, lr,
            weight_decay=tc.weight_decay, clip_norm=tc.clip_norm,
        )
        metrics = dict(metrics, **stats, lr=lr)
        return TrainState(state.step + 1, new_params, new_opt), metrics

    # -- state init / restore -----------------------------------------------
    def init_state(self, params: Any = None) -> TrainState:
        """Step 0: ``params`` (a tree of the model's shapes, e.g. weights
        carried from the reference) or weights drawn from ``tc.seed``,
        with fresh AdamW moments; on a mesh each leaf is placed as it is
        drawn (the whole tree is never held twice) and the moments are
        zeros in their ZeRO-1 layout."""
        if self.mesh is None:
            if params is None:
                params = self.model.init(self.tc.seed, device=self.device)
            else:
                params = tree_map(lambda p: p.detach().to(self.device, torch.float32), params)
            step = torch.zeros((), dtype=torch.int32, device=self.device)
            return TrainState(step, params, adamw.init(params))
        sh = self.state_shardings()
        if params is None:
            params = map_specs(lambda path, spec: place(
                init_leaf(path, spec, self.tc.seed, device=self.device), _at(sh.params, path)),
                self.model.param_specs())
        else:
            params = tree_map(lambda p, s: place(p.detach().float() if not isinstance(p, Placed)
                                                 else p, s), params, sh.params)
        moments = [tree_map(lambda p, s: zeros(p.shape, torch.float32, s.mesh, s.spec),
                            params, m) for m in (sh.opt.mu, sh.opt.nu)]
        step = torch.zeros((), dtype=torch.int32, device=self.device)
        count = torch.zeros((), dtype=torch.int32, device=self.device)
        return TrainState(step, params, adamw.AdamWState(count, *moments))

    def abstract_state(self) -> TrainState:
        """The state's shapes and dtypes on the ``meta`` device (a restore
        template; no memory)."""
        params = self.model.abstract_params()
        scalar = torch.empty((), dtype=torch.int32, device=torch.device("meta"))
        return TrainState(scalar, params, adamw.AdamWState(scalar, params, params))

    def restore_or_init(self, manager: Optional[CheckpointManager],
                        params: Any = None) -> Tuple[TrainState, Dict]:
        if manager is not None and manager.latest_step() is not None:
            state, meta = manager.restore(self.abstract_state(), device=self.device,
                                          shardings=self.state_shardings())
            log.info("restored checkpoint at step %s", meta["step"])
            return state, meta.get("meta", {})
        return self.init_state(params), {}

    # -- the fit loop ---------------------------------------------------------
    def fit(
        self,
        loader: DataLoader,
        *,
        steps: Optional[int] = None,
        manager: Optional[CheckpointManager] = None,
        fail_injector=None,
        policy: Optional[FaultPolicy] = None,
        params: Any = None,
    ) -> Dict[str, list]:
        """Train to ``steps`` (default ``tc.steps``) from the newest
        checkpoint of ``manager``, else from ``params`` (else drawn
        weights). Returns the history: ``loss``, ``grad_norm``, ``lr`` and
        ``step`` every ``log_every`` steps and at the last, and
        ``restarts``."""
        steps = steps or self.tc.steps
        policy = policy or FaultPolicy()
        state, meta = self.restore_or_init(manager, params)
        if meta.get("loader_state"):
            loader.restore(meta["loader_state"])
        history: Dict[str, Any] = {"loss": [], "grad_norm": [], "lr": [], "step": [],
                                   "restarts": 0}
        step = int(state.step)
        it = iter(loader)
        total_failures = 0

        while step < steps:
            batch = next(it)
            retries = 0
            restored = False
            while True:
                try:
                    self.monitor.start()
                    if fail_injector is not None:
                        fail_injector(step)        # may raise StepFailure
                    new_state, metrics = self.step_fn(state, batch)
                    loss = float(metrics["loss"])  # waits for the device: honest step timing
                    self.monitor.stop()
                    break
                except StepFailure as err:
                    total_failures += 1
                    retries += 1
                    if total_failures > policy.max_total_failures:
                        raise RuntimeError(
                            f"failure budget exhausted ({total_failures})"
                        ) from err
                    if retries <= policy.max_retries_per_step:
                        log.warning("step %d failed (%s); retry %d", step, err, retries)
                        continue
                    # persistent failure: checkpoint-restart
                    if manager is None:
                        raise
                    log.warning("step %d persistently failing; restoring", step)
                    state, m = self.restore_or_init(manager, params)
                    if m.get("loader_state"):
                        loader.restore(m["loader_state"])
                    step = int(state.step)
                    history["restarts"] += 1
                    restored = True
                    break
            if restored:
                continue                            # refetch batch at restored step

            state = new_state
            step += 1
            if step % self.tc.log_every == 0 or step == steps:
                history["loss"].append(loss)
                history["grad_norm"].append(float(metrics["grad_norm"]))
                history["lr"].append(float(metrics["lr"]))
                history["step"].append(step)
                log.info("step %d loss %.4f", step, loss)
            if manager is not None and (
                step % self.tc.checkpoint_every == 0 or step == steps
            ):
                manager.save(step, state, meta={"loader_state": loader.state()})
        loader.close()
        self.state = state
        return history
