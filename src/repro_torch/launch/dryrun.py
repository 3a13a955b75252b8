"""Dry run of every (arch x shape x production mesh) cell: a plan on ``meta``
tensors, ``python -m repro_torch.launch.dryrun [--arch a,b|all]
[--shape s|all] [--mesh single|multi|both] [--out DIR] [--force]``.

The port of ``repro.launch.dryrun``. The reference lowers and compiles
each cell's step for 256 or 512 placeholder devices and reads the
compiler's memory and cost analyses. Eager PyTorch has nothing to lower,
so the port plans the cell instead. It builds the production mesh over
``meta`` devices (``launch/mesh.make_production_mesh``), places the
cell's arguments by the port's own rules, and counts. It allocates
nothing and touches no device. One JSON record a cell,
``{arch}__{shape}__{mesh}.json``, with:

* ``memory_analysis``: ``argument_size_in_bytes``, the bytes one device
  holds of the step's arguments. Every split is even, so every device
  holds the same: each leaf's shard by its ``PartitionSpec``, counted
  from the shapes. ``output_size_in_bytes`` and ``alias_size_in_bytes``
  follow the reference's donation. The train state, the prefill's cache
  and the decode step's cache are donated, so their outputs alias their
  arguments. There is no compiler, so no temporaries are counted:
  ``temps`` says so, and no ``temp_size_in_bytes`` is written.
* ``parsed_cost``, a device's share of the step:
    - ``flops``: the products that ``torch.utils.flop_counter`` counts
      while the port's own step runs on ``meta`` tensors at the cell's
      shapes: ``Model.loss_fn`` and its backward (train), ``Model.prefill``
      and ``Model.decode_step``. To stay fast, the count runs at one and
      two blocks of each kind (groups for the hybrid; encoder and decoder
      layers for encdec) and extrapolates to full depth; layers are alike,
      so this is exact. Then it is divided by the chips. The plain lane
      runs, with its attention kept for the backward as the card lane's
      K4 Function keeps it (q, k and v; the backward recomputes the
      forward). So a causal attention's products are counted dense, as
      the plain version computes them (K4 skips the masked blocks). The
      Mamba-1 scan is a Python loop over the sequence in its plain
      version; while counting it is replaced by a shape-only stand-in,
      and the elementwise work of it and of Mamba-2's SSD is reckoned
      from the shapes (``scan_flops``). Other elementwise work (norms,
      softmax, RoPE) is not counted, as the reference's HLO count holds
      only products. ``flops_counted`` and ``flops_reckoned`` are the two
      parts.
    - ``bytes`` (HBM traffic a device), one formula:
      ``argument_size_in_bytes + output_size_in_bytes + 2 * activations``.
      Each argument is read once and each output written once. For
      train, ``activations`` is the bytes of the tensors the step keeps
      for the backward, counted by a saved-tensors hook with each storage
      once and the arguments left out, over the chips; inside a remat unit
      (``models/remat.py``), what the config's policy keeps: the unit's
      inputs, and under ``dots`` its products' outputs. They are written
      in the forward and read in the backward. This is an even spread, a
      lower bound where ``model`` replicates the residual stream.
* ``collective_bytes`` a device, by op and ``total``: one analytic formula
  per collective that the port's mesh step makes through
  ``sharding/placed.py`` (:func:`collective_plan`). A device's bytes for
  one collective are the larger of its input and its output, as the
  reference's HLO count takes them.
    - train: the FSDP all-gathers of the weights over ``data`` and the
      reduce-scatters of their gradients (the gathers' backward); the
      ``model`` all-gathers and all-reduces of each block, forward and
      backward, and the forward's again where remat recomputes the block's
      unit in the backward; the replicas' gradient all-reduces
      (``placed.reduce_replicas``). All of these, for every microbatch.
      Moving a leaf between layouts (``placed.place``, ZeRO-1's moments)
      and the gather of vocab-parallel logits are copies, not placed
      collectives, and are not counted.
    - prefill and decode: the ``model`` collectives of the blocks,
      forward only, on the serve rules' specs. The port serves on one
      device, so this is what its mesh blocks would move there.
    - image: the halo exchange of the row bands, as a
      ``collective-permute``: ``radius`` rows from each neighbour.

A cell that ``cell_plan`` skips is written ``skipped`` with the reason. A
cell that raises is written ``error`` with its traceback, and the run
exits 1. Records go to ``--out`` (default ``build/dryrun``), which
``python -m repro_torch.roofline.analysis --dryrun DIR`` reads.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import SHAPES, ModelConfig, get_config, list_archs
from repro_torch.launch.mesh import MESH_SHAPES, make_production_mesh
from repro_torch.launch.specs import (
    _meta,
    abstract_cache,
    batch_logical_axes,
    cache_logical_axes,
    cell_plan,
    input_specs,
)
from repro_torch.models import Model, attention, remat, ssm
from repro_torch.models.layers import torch_dtype
from repro_torch.models.moe import group_size
from repro_torch.models.transformer import block_plan
from repro_torch.sharding.partition import specs_for_tree
from repro_torch.sharding.rules import PartitionSpec, logical_to_spec
from repro_torch.tree import leaves, leaves_with_path, tree_map, unflatten

__all__ = [
    "MICROBATCHES",
    "meta_mesh",
    "shard_nbytes",
    "train_state_plan",
    "cell_arguments",
    "memory_analysis",
    "step_cost",
    "scan_flops",
    "collective_plan",
    "run_cell",
    "main",
]

META = torch.device("meta")
MICROBATCHES = 4        # the reference's train cell: 4 microbatches of 64 sequences
_OPS = ("all-gather", "all-reduce", "reduce-scatter")


def meta_mesh(multi_pod: bool = False):
    """The production mesh (16x16, or 2x16x16) over ``meta`` devices."""
    n = math.prod(MESH_SHAPES["multi_pod" if multi_pod else "single_pod"][0])
    return make_production_mesh([META] * n, multi_pod=multi_pod)


def _parts(mesh, spec: PartitionSpec, dim: int) -> int:
    return math.prod(mesh.shape[a] for a in spec.axes(dim))


def shard_nbytes(t: torch.Tensor, spec: PartitionSpec, mesh) -> int:
    """Bytes of one position's shard of ``t`` under ``spec`` (every split even)."""
    n = 1
    for dim, size in enumerate(t.shape):
        n *= size // _parts(mesh, spec, dim)
    return n * t.element_size()


def _tree_nbytes(tree: Any, specs: Any, mesh) -> int:
    return sum(shard_nbytes(t, s, mesh) for t, s in zip(leaves(tree), leaves(specs)))


# ---------------------------------------------------------------------------
# The cell's arguments and outputs
# ---------------------------------------------------------------------------

def train_state_plan(cfg: ModelConfig, mesh, microbatches: int = MICROBATCHES):
    """(the train state on ``meta``, its tree of specs): f32 weights and
    AdamW moments as ``Trainer(cfg, ..., mesh=mesh)`` places them (train
    rules, ZeRO-1 moments)."""
    from repro_torch.train.loop import TrainConfig, Trainer

    trainer = Trainer(cfg, TrainConfig(microbatches=microbatches), mesh=mesh)
    specs = tree_map(lambda sh: sh.spec, trainer.state_shardings())
    return trainer.abstract_state(), specs


def _batch_specs(batch: Dict[str, torch.Tensor], mesh) -> Dict[str, PartitionSpec]:
    axes = batch_logical_axes(batch)
    return {k: logical_to_spec(axes[k], mesh, tuple(v.shape)) for k, v in batch.items()}


def _prefill_batch(cfg: ModelConfig, shape_name: str) -> Dict[str, torch.Tensor]:
    """The cell's batch without the loss's labels and weights."""
    batch = input_specs(cfg, shape_name)
    batch.pop("labels", None)
    batch.pop("loss_weights", None)
    return batch


def cell_arguments(cfg: ModelConfig, shape_name: str, mesh) -> Dict[str, Any]:
    """The cell's step as the reference lowers it: ``args`` and ``outputs``
    (name -> (tree of ``meta`` tensors, tree of specs)) and the names of
    the donated arguments, whose outputs alias them."""
    kind = cell_plan(cfg)[shape_name][0]
    if kind == "image":
        batch = input_specs(cfg, shape_name)
        images, spec = batch["images"], _batch_specs(batch, mesh)["images"]
        return {"args": {"images": (images, spec)},
                "outputs": {"magnitude": (images, spec)}, "donated": ()}
    sh = SHAPES[shape_name]
    model = Model(cfg)
    if kind == "train":
        state, specs = train_state_plan(cfg, mesh)
        batch = input_specs(cfg, shape_name)
        metrics = {k: _meta((), torch.float32) for k in ("loss", "xent", "grad_norm", "lr")}
        return {"args": {"state": (state, specs), "batch": (batch, _batch_specs(batch, mesh))},
                "outputs": {"state": (state, specs),
                            "metrics": (metrics, {k: PartitionSpec() for k in metrics})},
                "donated": ("state",)}
    params = model.abstract_params(torch.bfloat16)
    p_specs = specs_for_tree(model.logical_axes(), mesh, params, rules="serve")
    cache = abstract_cache(cfg, sh.global_batch, sh.seq_len)
    c_specs = specs_for_tree(cache_logical_axes(cfg, mesh.shape.get("model", 1)), mesh, cache,
                             rules="serve")
    b = sh.global_batch
    logits = _meta((b, 1, cfg.vocab_size), torch_dtype(cfg.dtype))
    outputs = {"logits": (logits, logical_to_spec(("batch", None, "vocab"), mesh, logits.shape,
                                                  rules="serve")),
               "cache": (cache, c_specs)}
    args = {"params": (params, p_specs)}
    if kind == "prefill":
        batch = _prefill_batch(cfg, shape_name)
        args["batch"] = (batch, _batch_specs(batch, mesh))
        args["cache"] = (cache, c_specs)
    else:
        tokens = _meta((b, 1), torch.int32)
        args["cache"] = (cache, c_specs)
        args["tokens"] = (tokens, logical_to_spec(("batch", None), mesh, (b, 1)))
        args["index"] = (_meta((), torch.int32), PartitionSpec())
    return {"args": args, "outputs": outputs, "donated": ("cache",)}


def memory_analysis(cell: Dict[str, Any], mesh) -> Dict[str, Any]:
    """One device's argument, output and aliased bytes (the compiler's
    names; no temporaries: there is no compiler)."""
    arg = {k: _tree_nbytes(t, s, mesh) for k, (t, s) in cell["args"].items()}
    out = {k: _tree_nbytes(t, s, mesh) for k, (t, s) in cell["outputs"].items()}
    return {"argument_size_in_bytes": sum(arg.values()),
            "output_size_in_bytes": sum(out.values()),
            "alias_size_in_bytes": sum(arg[k] for k in cell["donated"]),
            "arguments": arg, "temps": "not counted"}


# ---------------------------------------------------------------------------
# Flops and the activations kept for the backward, on meta tensors
# ---------------------------------------------------------------------------

def _scan_stand_in(x, dt, b_mat, c_mat, a, **_kw):
    """The Mamba-1 scan's shapes and dependencies, without its loop."""
    return (x.float() * dt,
            torch.zeros((x.shape[0], x.shape[2], b_mat.shape[-1]), device=x.device))


class _Recomputed(torch.autograd.Function):
    """The plain attention as the card lane trains it (``K4Attention``):
    the forward keeps only q, k and v, and the backward recomputes the
    forward and differentiates it."""

    @staticmethod
    def forward(ctx, q, k, v, fn, kw):
        ctx.fn, ctx.kw = fn, kw
        ctx.save_for_backward(q, k, v)
        return fn(q, k, v, **kw)

    @staticmethod
    def backward(ctx, grad_out):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            grads = torch.autograd.grad(ctx.fn(*ins, **ctx.kw), ins, grad_out)
        return (*grads, None, None)


@contextlib.contextmanager
def _card_lane_shapes():
    """While counting: the Mamba-1 scan replaced by a shape-only stand-in,
    and the plain attention kept for the backward as K4's Function keeps
    it."""
    real_scan, real_dot = ssm.selective_scan, attention.dot_attention

    def dot(q, k, v, **kw):
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            return _Recomputed.apply(q, k, v, real_dot, kw)
        return real_dot(q, k, v, **kw)

    ssm.selective_scan, attention.dot_attention = _scan_stand_in, dot
    try:
        yield
    finally:
        ssm.selective_scan, attention.dot_attention = real_scan, real_dot


def _depth_units(cfg: ModelConfig) -> Tuple[int, ...]:
    """The depth as block counts: (layers,), (groups,) for the hybrid,
    (encoder layers, decoder layers) for encdec."""
    if cfg.family == "hybrid":
        return (cfg.num_layers // cfg.attn_every,)
    if cfg.family == "encdec":
        return (cfg.encoder_layers, cfg.num_layers)
    return (cfg.num_layers,)


def _cut(cfg: ModelConfig, units: Tuple[int, ...]) -> ModelConfig:
    if cfg.family == "hybrid":
        return cfg.replace(num_layers=units[0] * cfg.attn_every)
    if cfg.family == "encdec":
        return cfg.replace(encoder_layers=units[0], num_layers=units[1])
    return cfg.replace(num_layers=units[0])


def _run_step(cfg: ModelConfig, kind: str, batch: Dict[str, torch.Tensor], seq_len: int
              ) -> Tuple[float, int]:
    """(products' flops, bytes of the tensors kept for the backward) of one
    step of ``cfg`` on ``meta`` tensors, the plain lane. Inside a remat
    unit the checkpoint's own hooks take the saved tensors, so there the
    keep is counted from the units' arguments (``remat.tally_keep``): each
    unit's inputs, and under ``dots`` the outputs of its kept products.
    The flops count the backward's recompute of every unit too."""
    model = Model(cfg, backend="torch")
    b = next(iter(batch.values())).shape[0]
    dtype = torch.float32 if kind == "train" else torch.bfloat16
    params = model.abstract_params(dtype)
    owned = {t.untyped_storage()._cdata for t in leaves(params)}
    owned |= {t.untyped_storage()._cdata for t in batch.values()}
    saved: Dict[int, Tuple[int, torch.Tensor]] = {}

    def pack(t):
        key = t.untyped_storage()._cdata
        if key not in owned:
            saved.setdefault(key, (t.untyped_storage().nbytes(), t))
        return t

    with FlopCounterMode(display=False) as counter, _card_lane_shapes():
        if kind == "train":
            flat = [p.requires_grad_(True) for p in leaves(params)]
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), \
                    remat.tally_keep() as units:
                loss, _ = model.loss_fn(unflatten(params, flat), batch)
            for key, kept in units.inputs.items():
                if key not in owned:
                    saved.setdefault(key, kept)
            torch.autograd.grad(loss, flat, allow_unused=True)
        elif kind == "prefill":
            model.prefill(params, batch, abstract_cache(cfg, b, seq_len))
        else:
            # (B,) per-slot positions: a scalar index would be read on the host
            model.decode_step(params, abstract_cache(cfg, b, seq_len), batch["tokens"],
                              _meta((b,), torch.int32))
    kept = sum(n for n, _t in saved.values())
    return float(counter.get_total_flops()), kept + (units.saved_bytes if kind == "train" else 0)


def scan_flops(cfg: ModelConfig, kind: str, batch: int, seq: int) -> float:
    """The scans' elementwise flops of one step, reckoned from the shapes.
    Mamba-1, a layer: about 6 operations a (token, channel, state)
    (``dt*A``, ``h*da``, ``dt*x``, ``*B``, ``+``, ``h*C``: chip_smoke's
    ``scan_bound``). Mamba-2's SSD, a layer: the intra-chunk decay matrix
    (difference, exp, weight: 3 a (token, chunk position, head)), the
    inter-chunk recurrence (2 a (chunk, head, head dim, state)) and the
    decays of x and of the entering state (3 a (token, channel)). Decode
    runs one step of the recurrence (6 a (channel, state)). The backward
    is reckoned at twice the forward."""
    if cfg.family == "ssm":
        per_token = 6 * cfg.d_inner * cfg.ssm_state
        fwd = cfg.num_layers * batch * (1 if kind == "decode" else seq) * per_token
    elif cfg.family == "hybrid":
        nh, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        if kind == "decode":
            fwd = cfg.num_layers * batch * 6 * nh * p * n
        else:
            q = ssm._pick_chunk(seq, cfg.ssm_chunk)
            per_layer = batch * (3 * seq * q * nh + 2 * (seq // q) * nh * p * n
                                 + 3 * seq * nh * p)
            fwd = cfg.num_layers * per_layer
    else:
        return 0.0
    return float(fwd * (3 if kind == "train" else 1))


def step_cost(cfg: ModelConfig, shape_name: str, microbatches: int = MICROBATCHES
              ) -> Dict[str, float]:
    """The whole step's counted products, reckoned scan flops and kept
    activations (all devices together), at full depth."""
    kind = cell_plan(cfg)[shape_name][0]
    sh = SHAPES[shape_name]
    if kind == "train":
        batch = input_specs(cfg, shape_name)
        batch = {k: _meta((v.shape[0] // microbatches,) + tuple(v.shape[1:]), v.dtype)
                 for k, v in batch.items()}
        reps = microbatches
    elif kind == "prefill":
        batch = _prefill_batch(cfg, shape_name)
        reps = 1
    else:
        batch = {"tokens": _meta((sh.global_batch, 1), torch.int32)}
        reps = 1
    full = _depth_units(cfg)
    base = (1,) * len(full)
    f0, a0 = _run_step(_cut(cfg, base), kind, batch, sh.seq_len)
    flops, acts = f0, a0
    for i, n in enumerate(full):
        more = tuple(2 if j == i else 1 for j in range(len(full)))
        f1, a1 = _run_step(_cut(cfg, more), kind, batch, sh.seq_len)
        flops += (n - 1) * (f1 - f0)
        acts += (n - 1) * (a1 - a0)
    return {"products": reps * flops, "activations": reps * acts,
            "reckoned": scan_flops(cfg, kind, sh.global_batch, sh.seq_len)}


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _local(t: torch.Tensor, spec: PartitionSpec, mesh, stacked: bool = False) -> Tuple[int, ...]:
    """The shape a position computes with (``_position_weights``): a dim
    split over ``model`` is its slice, any other split is gathered; a
    stacked leaf's layer axis dropped."""
    m = mesh.shape.get("model", 1)
    shape = tuple(n // m if spec.axes(d) == ("model",) else n for d, n in enumerate(t.shape))
    return shape[1:] if stacked else shape


def _block_leaves(params, specs, path: Tuple[str, ...], mesh, stacked: bool) -> Dict:
    """{sub-path: local shape} of the block at ``path`` of the tree."""
    node, snode = params, specs
    for key in path:
        node, snode = node[key], snode[key]
    return {"/".join(p): _local(t, s, mesh, stacked)
            for (p, t), s in zip(leaves_with_path(node), leaves(snode))}


class _Tally:
    """Bytes a device by op. ``backward``: the collective's autograd twin
    moves the same bytes again (an all-gather's is a reduce-scatter, an
    all-reduce's an all-reduce). ``runs``: how often the forward's
    collective runs (twice inside a remat unit, whose forward the backward
    runs again)."""

    def __init__(self, backward: bool):
        self.backward = backward
        self.runs = 1
        self.bytes = {op: 0.0 for op in _OPS}

    def gather(self, nbytes: float, times: float) -> None:
        self.bytes["all-gather"] += nbytes * times * self.runs
        if self.backward:
            self.bytes["reduce-scatter"] += nbytes * times

    def reduce(self, nbytes: float, times: float) -> None:
        self.bytes["all-reduce"] += nbytes * times * (self.runs + int(self.backward))


def _block_collectives(tally: _Tally, cfg: ModelConfig, lp: Dict[str, Tuple[int, ...]],
                       b_l: int, s: int, elt: int, times: float, batch_shards: int,
                       cross: bool) -> None:
    """A block's ``model`` collectives (``transformer.mesh_block``) for one
    position's ``b_l`` rows of ``s`` tokens, ``times`` over."""
    d = cfg.d_model
    act = b_l * s * d * elt
    if "mamba/in_proj" in lp:                                   # Mamba-1 (ssm.mamba1_mesh)
        di = cfg.d_inner
        if lp["mamba/in_proj"][-1] < 2 * di:
            tally.gather(b_l * s * 2 * di * elt, times)
        if lp["mamba/conv_b"][0] < di:
            tally.reduce(b_l * s * (cfg.ssm_dt_rank + 2 * cfg.ssm_state) * elt, times)
            tally.reduce(act, times)
        return
    if "mamba/wx" in lp:                                        # Mamba-2 (ssm.mamba2_mesh)
        if lp["mamba/wx"][-1] < cfg.d_inner:
            tally.reduce(b_l * s * 4, times)                    # the f32 sum of squares
            tally.reduce(act, times)
        return
    if cfg.attn_type == "mla" and cfg.q_lora_rank and lp["attn/wq_a"][1] < cfg.q_lora_rank:
        tally.gather(b_l * s * cfg.q_lora_rank * elt, times)
    if lp["attn/wo"][0] < cfg.num_heads:
        tally.reduce(act, times)
    if cross and lp["cross/wo"][0] < cfg.num_heads:
        tally.reduce(act, times)
    if cfg.family == "moe":                                     # moe.moe_mesh
        if (b_l * s) % group_size(cfg, b_l * s * batch_shards):
            tally.gather(b_l * batch_shards * s * d * elt, times)
        if lp["ffn/w_up"][0] < cfg.num_experts or lp["ffn/w_up"][-1] < cfg.d_ff:
            tally.reduce(act, times)
    elif lp["ffn/w_down"][0] < cfg.d_ff:
        tally.reduce(act, times)


def collective_plan(cfg: ModelConfig, kind: str, mesh, params: Any, specs: Any, *,
                    batch: int, seq: int, microbatches: int = 1) -> Dict[str, float]:
    """Bytes a device moves through ``sharding/placed.py``'s collectives in
    one step (see the module docstring), by op and ``total``. ``params``
    and ``specs`` are the weights on ``meta`` and their specs (train or
    serve rules); ``batch`` rows of ``seq`` tokens (a VLM's text tokens:
    its patches are added here), split into ``microbatches``."""
    train = kind == "train"
    tally = _Tally(backward=train)
    rows = batch // microbatches if train else batch
    s = 1 if kind == "decode" else seq
    spec0 = logical_to_spec(("batch", None), mesh, (rows, s))
    batch_shards = _parts(mesh, spec0, 0)
    b_l = rows // batch_shards
    elt = torch_dtype(cfg.dtype).itemsize
    reps = microbatches if train else 1

    if train:                                     # FSDP gathers (_position_weights)
        for t, sp in zip(leaves(params), leaves(specs)):
            size = shard_nbytes(t, sp, mesh)
            for dim in range(t.ndim):
                if sp.axes(dim) not in ((), ("model",)):
                    size *= _parts(mesh, sp, dim)
                    tally.gather(size, reps)
    emb = specs["embed"]["embedding"]
    if emb.axes(1) == ("model",) and mesh.shape.get("model", 1) > 1:      # mesh_embed
        tally.gather(b_l * s * cfg.d_model * elt, reps)
    if cfg.family == "vlm" and kind != "decode":
        s += cfg.num_patches
    if train:                                     # the blocks: remat units
        tally.runs = remat.forward_runs(cfg)
    if cfg.family == "encdec" and kind != "decode":                       # mesh_encode
        lp = _block_leaves(params, specs, ("encoder", "layers"), mesh, stacked=True)
        _block_collectives(tally, cfg, lp, b_l, cfg.encoder_len, elt,
                           reps * cfg.encoder_layers, batch_shards, cross=False)
    layer = _block_leaves(params, specs, ("layers",), mesh, stacked=True)
    for blk in block_plan(cfg, "dec"):
        lp = (_block_leaves(params, specs, ("shared",), mesh, stacked=False)
              if blk.layer == "shared" else layer)
        _block_collectives(tally, cfg, lp, b_l, s, elt, reps, batch_shards,
                           cross=cfg.family == "encdec" and blk.layer != "shared")
    tally.runs = 1
    if train:                                     # placed.reduce_replicas of every gradient
        for t, sp in zip(leaves(params), leaves(specs)):
            used = set(sp.used())
            for axis in mesh.axis_names:
                if axis not in used and mesh.shape[axis] > 1:
                    tally.bytes["all-reduce"] += shard_nbytes(t, sp, mesh) * reps
    out = {op: v for op, v in tally.bytes.items() if v}
    out["total"] = sum(out.values())
    return out


def _image_collectives(cfg: ModelConfig, images: torch.Tensor, spec: PartitionSpec, mesh
                       ) -> Dict[str, float]:
    """The row bands' halo exchange: ``radius`` rows of each band's width
    from each of its two neighbours, a device."""
    from repro_torch.core.filters import get_operator
    from repro_torch.sharding.halo import exchange_radius

    out: Dict[str, float] = {}
    if _parts(mesh, spec, 1) > 1:
        radius = exchange_radius(get_operator(cfg.edge_config().operator))
        b_l = images.shape[0] // _parts(mesh, spec, 0)
        w_l = images.shape[2] // _parts(mesh, spec, 2)
        out["collective-permute"] = float(2 * radius * b_l * w_l * images.element_size())
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# A cell
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, mesh_name: str, mesh,
             costs: Optional[Dict] = None) -> Dict[str, Any]:
    """One cell's record. ``costs`` keeps each (arch, shape)'s
    :func:`step_cost` for the cell's other mesh."""
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    cfg = get_config(arch)
    kind, skip = cell_plan(cfg)[shape_name]
    rec["kind"] = kind
    if skip:
        rec["status"] = "skipped"
        rec["skip_reason"] = skip
        return rec
    chips = math.prod(mesh.shape.values())
    t0 = time.perf_counter()
    cell = cell_arguments(cfg, shape_name, mesh)
    mem = memory_analysis(cell, mesh)
    rec["memory_analysis"] = mem
    moved = mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
    if kind == "image":
        images, spec = cell["args"]["images"]
        rec["parsed_cost"] = {"flops": 0.0, "flops_counted": 0.0, "flops_reckoned": 0.0,
                              "bytes": float(moved), "activations_bytes": 0.0,
                              "counted": "no products: the edge pipeline is elementwise"}
        rec["collective_bytes"] = _image_collectives(cfg, images, spec, mesh)
    else:
        costs = {} if costs is None else costs
        if (arch, shape_name) not in costs:
            costs[arch, shape_name] = step_cost(cfg, shape_name)
        cost = costs[arch, shape_name]
        acts = cost["activations"] / chips if kind == "train" else 0.0
        rec["parsed_cost"] = {
            "flops": (cost["products"] + cost["reckoned"]) / chips,
            "flops_counted": cost["products"] / chips,
            "flops_reckoned": cost["reckoned"] / chips,
            "bytes": float(moved + 2 * acts),
            "activations_bytes": acts,
            "counted": "products (torch.utils.flop_counter) of the plain lane on meta tensors",
            "reckoned": ("the Mamba-1 scan's and Mamba-2 SSD's elementwise work"
                         if cost["reckoned"] else "nothing"),
        }
        if kind == "train":
            state, specs = cell["args"]["state"]
            params, p_specs = state.params, specs.params
        else:
            params, p_specs = cell["args"]["params"]
        seq = SHAPES[shape_name].seq_len
        if cfg.family == "vlm" and kind != "decode":
            seq -= cfg.num_patches
        rec["collective_bytes"] = collective_plan(
            cfg, kind, mesh, params, p_specs, batch=SHAPES[shape_name].global_batch, seq=seq,
            microbatches=MICROBATCHES if kind == "train" else 1)
    rec["plan_s"] = round(time.perf_counter() - t0, 2)
    rec["status"] = "ok"
    print(f"    memory_analysis: { {k: v for k, v in mem.items() if k != 'arguments'} }")
    print(f"    cost_analysis:   { {k: rec['parsed_cost'][k] for k in ('flops', 'bytes')} }")
    print(f"    collectives:     "
          f"{ {k: round(v / 1e6, 1) for k, v in rec['collective_bytes'].items()} } MB")
    return rec


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="production-mesh dry run on meta tensors")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    meshes = {"single": ["single_pod"], "multi": ["multi_pod"],
              "both": ["single_pod", "multi_pod"]}[args.mesh]

    failures, costs = [], {}
    for arch in archs:
        cfg = get_config(arch)
        shape_names = list(cell_plan(cfg))
        if args.shape != "all":
            shape_names = [s for s in args.shape.split(",") if s in shape_names]
        for shape_name in shape_names:
            for mesh_name in meshes:
                out_path = os.path.join(args.out, f"{arch}__{shape_name}__{mesh_name}.json")
                if os.path.exists(out_path) and not args.force:
                    print(f"[skip existing] {out_path}")
                    continue
                print(f"[dryrun] {arch} x {shape_name} x {mesh_name}")
                mesh = meta_mesh(multi_pod=(mesh_name == "multi_pod"))
                try:
                    rec = run_cell(arch, shape_name, mesh_name, mesh, costs)
                except Exception as e:  # noqa: BLE001 -- recorded, and the run exits 1
                    rec = {
                        "arch": arch, "shape": shape_name, "mesh": mesh_name,
                        "status": "error", "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-4000:],
                    }
                    failures.append((arch, shape_name, mesh_name, str(e)[:200]))
                    print(f"    ERROR: {rec['error'][:300]}")
                with open(out_path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(f"    -> {out_path} [{rec['status']}]")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f4 in failures:
            print("  ", f4)
        raise SystemExit(1)
    print("\nall requested cells OK")


if __name__ == "__main__":
    main()
