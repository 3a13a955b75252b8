"""The port's dry run (``repro_torch.launch.dryrun``): one cell per family on
both production meshes (16x16 and 2x16x16 of ``meta`` devices) is ``ok``
and a full-attention ``long_500k`` cell ``skipped`` with the reference's
reason; a raising cell is recorded ``error`` and the run exits 1; the
planned per-position bytes of the weights and AdamW moments equal the
``Placed`` shards that ``Trainer(..., mesh=...)`` builds; the collective
formula equals what one SMOKE mesh step moves through
``sharding/placed.py`` (counted by wrapping its collectives here); and the
dry run makes no tensor off the ``meta`` device."""
import json
import math
from collections import defaultdict

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as ref_get_config
from repro.launch.specs import cell_plan as ref_cell_plan
from repro_torch.configs import get_config
from repro_torch.data.loader import DataLoader
from repro_torch.launch import dryrun
from repro_torch.runtime.elastic import make_mesh
from repro_torch.sharding import placed as P
from repro_torch.train import TrainConfig, Trainer
from repro_torch.tree import leaves, leaves_with_path

CPU = torch.device("cpu")
# One cell per family: (arch, shape).
FAMILY_CELLS = [("llama3.2-1b", "train_4k"), ("qwen3-moe-30b-a3b", "prefill_32k"),
                ("falcon-mamba-7b", "long_500k"), ("zamba2-2.7b", "train_4k"),
                ("whisper-large-v3", "decode_32k"), ("pixtral-12b", "prefill_32k"),
                ("sobel-hd", "edge_2k")]
# SMOKE mesh steps whose collectives are counted: (arch, microbatches, rows, seq).
STEP_CELLS = [("llama3.2-1b", 2, 4, 16), ("minicpm3-4b", 1, 4, 16),
              ("qwen3-moe-30b-a3b", 1, 4, 16), ("falcon-mamba-7b", 1, 4, 16),
              ("zamba2-2.7b", 1, 4, 16), ("whisper-large-v3", 1, 4, 16),
              ("pixtral-12b", 1, 4, 24)]


def _run(tmp_path, arch, shape, capsys=None):
    dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "both", "--out", str(tmp_path)])
    return {m: json.loads((tmp_path / f"{arch}__{shape}__{m}.json").read_text())
            for m in ("single_pod", "multi_pod")}


@pytest.mark.parametrize("arch,shape", FAMILY_CELLS)
def test_one_cell_per_family_on_both_meshes(tmp_path, capsys, arch, shape):
    recs = _run(tmp_path, arch, shape)
    out = capsys.readouterr().out
    for mesh, rec in recs.items():
        assert rec["status"] == "ok" and rec["kind"] == ref_cell_plan(ref_get_config(arch))[shape][0]
        mem = rec["memory_analysis"]
        assert mem["temps"] == "not counted" and "temp_size_in_bytes" not in mem
        assert mem["argument_size_in_bytes"] == sum(mem["arguments"].values()) > 0
        assert 0 <= mem["alias_size_in_bytes"] <= mem["output_size_in_bytes"]
        pc = rec["parsed_cost"]
        assert pc["bytes"] >= mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
        assert pc["flops"] == pc["flops_counted"] + pc["flops_reckoned"]
        assert (pc["flops"] > 0) == (arch != "sobel-hd")
        assert (pc["flops_reckoned"] > 0) == (arch in ("falcon-mamba-7b", "zamba2-2.7b"))
        coll = rec["collective_bytes"]
        assert coll["total"] == sum(v for k, v in coll.items() if k != "total") > 0
    single, multi = recs["single_pod"], recs["multi_pod"]
    # twice the devices: a device holds at most what it held on one pod
    assert (multi["memory_analysis"]["argument_size_in_bytes"]
            <= single["memory_analysis"]["argument_size_in_bytes"])
    assert multi["parsed_cost"]["flops"] == pytest.approx(single["parsed_cost"]["flops"] / 2)
    assert out.count("memory_analysis:") == out.count("cost_analysis:") == 2
    assert out.count("collectives:") == 2 and "all requested cells OK" in out


def test_full_attention_long_500k_is_skipped(tmp_path, capsys):
    recs = _run(tmp_path, "glm4-9b", "long_500k")
    want = ref_cell_plan(ref_get_config("glm4-9b"))["long_500k"][1]
    for rec in recs.values():
        assert rec["status"] == "skipped" and rec["skip_reason"] == want
    assert "[skipped]" in capsys.readouterr().out


def test_a_raising_cell_is_recorded_and_exits_1(tmp_path, monkeypatch):
    def boom(*_a, **_k):
        raise ValueError("planned failure")

    monkeypatch.setattr(dryrun, "run_cell", boom)
    with pytest.raises(SystemExit) as exit_info:
        dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k", "--mesh", "single",
                     "--out", str(tmp_path)])
    assert exit_info.value.code == 1
    rec = json.loads((tmp_path / "llama3.2-1b__decode_32k__single_pod.json").read_text())
    assert rec["status"] == "error" and rec["error"] == "ValueError: planned failure"
    assert "planned failure" in rec["traceback"]


def _cpu_mesh(shape=(2, 2)):
    return make_mesh([CPU] * math.prod(shape), model_parallel=shape[-1],
                     pods=shape[0] if len(shape) == 3 else 1)


@pytest.mark.parametrize("shape", [(2, 2), (2, 2, 2)])
def test_planned_state_bytes_equal_the_placed_shards(shape):
    """SMOKE llama's weights and AdamW moments: the plan's bytes a position
    equal each ``Placed`` shard's ``nbytes``, leaf by leaf, at every
    position, and its argument count is their sum."""
    cfg = get_config("llama3.2-1b", smoke=True)
    mesh = _cpu_mesh(shape)
    state = Trainer(cfg, TrainConfig(batch=4, seq_len=16), mesh=mesh).init_state()
    plan, specs = dryrun.train_state_plan(cfg, mesh)
    per_pos = defaultdict(int)
    for part in ("params", "mu", "nu"):
        got = state.params if part == "params" else getattr(state.opt, part)
        want = plan.params if part == "params" else getattr(plan.opt, part)
        sp = specs.params if part == "params" else getattr(specs.opt, part)
        for (path, leaf), t, s in zip(leaves_with_path(got), leaves(want), leaves(sp)):
            assert isinstance(leaf, P.Placed) and leaf.spec == s, path
            planned = dryrun.shard_nbytes(t, s, mesh)
            for pos, shard in leaf.shards.items():
                assert shard.nbytes == planned, (part, path, pos)
                per_pos[pos] += shard.nbytes
    assert len(per_pos) == mesh.size and len(set(per_pos.values())) == 1
    cell = {"args": {"state": (plan, specs)}, "outputs": {}, "donated": ()}
    scalars = 2 * 4                         # the step and AdamW's count, int32
    assert (dryrun.memory_analysis(cell, mesh)["argument_size_in_bytes"]
            == next(iter(per_pos.values())) + scalars)


class _Counted:
    """Bytes through ``placed``'s collectives, by op: each member's output
    (all-gather, all-reduce) or input (reduce-scatter), and the autograd
    backward of the all-gathers (a reduce-scatter of the gathered
    gradients) and of the all-reduces."""

    def __init__(self, monkeypatch):
        self.fwd = defaultdict(lambda: defaultdict(int))    # op -> position -> bytes
        self.bwd = defaultdict(int)                         # op -> bytes, all positions
        real = {n: getattr(P, n) for n in ("all_gather", "all_reduce", "reduce_scatter")}

        def wrap(name, op, by_input):
            def fn(values, *a, **k):
                out = real[name](values, *a, **k)
                for pos, t in (values if by_input else out).items():
                    self.fwd[op][pos] += t.nbytes
                return out
            return fn

        monkeypatch.setattr(P, "all_gather", wrap("all_gather", "all-gather", False))
        monkeypatch.setattr(P, "all_reduce", wrap("all_reduce", "all-reduce", False))
        monkeypatch.setattr(P, "reduce_scatter", wrap("reduce_scatter", "reduce-scatter", True))
        for cls, op in ((P._AllGather, "reduce-scatter"), (P._AllReduce, "all-reduce")):
            real_bwd = cls.backward

            def bwd(ctx, *grads, _real=real_bwd, _op=op):
                self.bwd[_op] += sum(g.nbytes for g in grads if g is not None)
                return _real(ctx, *grads)

            monkeypatch.setattr(cls, "backward", staticmethod(bwd))

    def per_device(self, n_positions: int):
        """Each op's bytes a position; every position moves the same."""
        out = {}
        for op in set(self.fwd) | set(self.bwd):
            per = self.fwd[op]
            assert len(set(per.values())) <= 1 and len(per) in (0, n_positions), (op, per)
            total = sum(per.values()) + self.bwd[op]
            if total:
                out[op] = total / n_positions
        return out


@pytest.mark.parametrize("arch,microbatches,rows,seq", STEP_CELLS)
def test_collective_formula_equals_one_smoke_mesh_step(monkeypatch, arch, microbatches, rows,
                                                      seq):
    cfg = get_config(arch, smoke=True)
    mesh = _cpu_mesh()
    trainer = Trainer(cfg, TrainConfig(batch=rows, seq_len=seq, microbatches=microbatches),
                      mesh=mesh)
    state = trainer.init_state()
    loader = DataLoader(cfg, rows, seq, mesh=mesh, seed=0)
    batch = next(loader)
    loader.close()
    counted = _Counted(monkeypatch)
    _new, metrics = trainer.step_fn(state, batch)
    assert torch.isfinite(metrics["loss"])
    plan, specs = dryrun.train_state_plan(cfg, mesh, microbatches)
    want = dryrun.collective_plan(cfg, "train", mesh, plan.params, specs.params, batch=rows,
                                  seq=batch["tokens"].shape[1], microbatches=microbatches)
    got = counted.per_device(mesh.size)
    assert want.pop("total") == sum(got.values())
    assert got == want


class _OnlyMeta(TorchDispatchMode):
    """Every tensor an op makes, and the device of each that is not on meta."""

    def __init__(self):
        super().__init__()
        self.off_meta = []
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.ops += 1
                if t.device.type != "meta":
                    self.off_meta.append((str(func), t.device.type, tuple(t.shape)))
        return out


@pytest.mark.parametrize("arch,shape", [("llama3.2-1b", "train_4k"),
                                        ("falcon-mamba-7b", "prefill_32k"),
                                        ("whisper-large-v3", "decode_32k")])
def test_the_dry_run_makes_nothing_off_meta(arch, shape):
    """The dry run's own tensors are all ``meta``. The only others are the
    model code's host constants, each of at most 64 elements: the RoPE
    frequency table, wrapped from numpy before it moves to the input's
    device, and a cache index as a 0-d tensor."""
    mode = _OnlyMeta()
    with mode:
        rec = dryrun.run_cell(arch, shape, "single_pod", dryrun.meta_mesh())
    assert rec["status"] == "ok" and mode.ops > 100
    assert all(math.prod(s) <= 64 for _f, _d, s in mode.off_meta), mode.off_meta


# The dry run counts what a train step keeps from the saved-tensors hook
# outside the remat units and from the units' arguments inside them; the
# step's measured keep (``remat.measure_keep``: the storages its operations
# made that are alive when the forward returns) misses the model's host
# constants (the RoPE table, wrapped from numpy) and counts the loss
# scalars. Observed within 2.1% of each other without remat (zamba2) and
# within 16 bytes under it.
KEEP_TOL = 0.05
KEEP_ARCHS = ("llama3.2-1b", "qwen3-moe-30b-a3b", "minicpm3-4b", "falcon-mamba-7b",
              "zamba2-2.7b", "whisper-large-v3", "pixtral-12b")


@pytest.mark.parametrize("arch", KEEP_ARCHS)
def test_counted_keep_follows_a_smoke_steps_measured_keep_under_each_policy(arch):
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import Model, remat
    from repro_torch.tree import unflatten

    counted, measured, flops = {}, {}, {}
    for pol in ("none", "minimal", "dots"):
        cfg = get_config(arch, smoke=True)
        cfg = cfg.replace(remat=False) if pol == "none" else cfg.replace(remat_policy=pol)
        seq = 16 + (cfg.num_patches if cfg.family == "vlm" else 0)
        batch = {k: torch.from_numpy(v) for k, v in lm_batch(cfg, 2, seq, seed=0).items()}
        meta = {k: torch.empty_like(v, device="meta") for k, v in batch.items()}
        flops[pol], counted[pol] = dryrun._run_step(cfg, "train", meta, seq)
        params = Model(cfg).init(0, device="cpu")
        flat = [p.requires_grad_(True) for p in leaves(params)]
        with dryrun._card_lane_shapes():
            _, measured[pol] = remat.measure_keep(Model(cfg, backend="torch").loss_fn,
                                                  unflatten(params, flat), batch)
        assert abs(counted[pol] - measured[pol]) <= KEEP_TOL * measured[pol], (pol, counted,
                                                                                measured)
    for keep in (counted, measured):
        assert keep["minimal"] < keep["dots"] < keep["none"], keep
    # the backward's recompute of each unit: its products counted again
    assert flops["minimal"] > flops["none"] and flops["dots"] >= flops["none"], flops
