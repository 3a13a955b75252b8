"""Training on a mesh (``train/loop.py`` with ``mesh=``, ``models/transformer.
mesh_forward``, ``sharding/placed.py``, ``optim/adamw.py`` on placed state,
``data/loader.py`` and ``checkpoint/manager.py`` with a mesh, ``runtime/
elastic.reshard``, ``launch/train.py``) on logical meshes of
``[torch.device("cpu")] * N``.

The mesh trainer is held to the port's single-device trainer (itself held
to the reference's in ``test_torch_train.py``) and, at step 0, to the
reference's ``Trainer``. Tolerances, f32, llama3.2-1b SMOKE: the loss
within 1e-5 relative; every gathered gradient (and updated leaf) within
5e-5 of its largest value. Tensor parallelism changes the order of f32
sums (each ``model`` position's partial ``wo``/``w_down`` product, summed
after); observed up to 1.34e-5 on the 1x4 mesh, where moving the
embeddings by one ulp moves the single-device gradients by ~1e-4 (a
random-weight model's sharp attention). In f64 the same comparison holds
within 2e-6 (observed 4.6e-7: the model's f32 parts, RoPE, norms, scores
and the cross-entropy, still round)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data import DataLoader as RefLoader
from repro.optim import adamw as radamw
from repro.train import TrainConfig as RefTrainConfig
from repro.train import Trainer as RefTrainer
from repro.train import TrainState as RefState
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.loader import DataLoader
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import train as launch_train
from repro_torch.models import Model, carry_params
from repro_torch.models import attention as A
from repro_torch.models import remat
from repro_torch.runtime.elastic import make_mesh, reshard
from repro_torch.sharding import placed as P
from repro_torch.sharding.partition import shardings_for_tree
from repro_torch.sharding.placed import Placed, gather
from repro_torch.sharding.rules import PartitionSpec, logical_to_spec
from repro_torch.train import TrainConfig, Trainer
from repro_torch.tree import leaves, leaves_with_path, tree_map

ARCH = "llama3.2-1b"
CPU = torch.device("cpu")
MESHES = {"2x2": (4, 2, 1), "1x4": (4, 4, 1), "2x2x2": (8, 2, 2)}
LOSS_RTOL, GRAD_TOL, F64_TOL = 1e-5, 5e-5, 2e-6
KW = dict(batch=4, seq_len=16, steps=6, peak_lr=5e-3, warmup_steps=2, log_every=1)


def _mesh(name):
    n, model, pods = MESHES[name]
    return make_mesh([CPU] * n, model_parallel=model, pods=pods)


def _cfg(dtype="float32"):
    return get_config(ARCH, smoke=True).replace(dtype=dtype)


def _batch(cfg, batch=4, seq=16):
    loader = DataLoader(cfg, batch, seq, seed=0, device="cpu")
    out = next(loader)
    loader.close()
    return out


def _rel(got, want) -> float:
    got, want = gather(got).double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("name", MESHES)
def test_one_f32_step_on_a_mesh_matches_one_device(name):
    """One step: the loss, every gathered gradient, and the updated weights
    and moments against the single-device trainer from the same weights and
    batch. On 1x4 the 2 KV heads do not split 4 ways: ``wk``/``wv`` stay
    replicated and each position reads the KV head its query heads map to."""
    cfg, tc = _cfg(), TrainConfig(**KW)
    mesh = _mesh(name)
    single = Trainer(cfg, tc, device="cpu")
    state = single.init_state(Model(cfg).init(1, device="cpu"))
    batch = _batch(cfg)
    tr = Trainer(cfg, tc, mesh=mesh)
    mstate = tr.init_state(state.params)
    kv_axes = tr.state_shardings().params["layers"]["attn"]["wk"].spec.used()
    assert ("model" in kv_axes) == (name != "1x4")

    want_g, want_m = single.grads_of(state.params, batch)
    got_g, got_m = tr.mesh_grads_of(mstate.params, tr._microbatches(batch)[0])
    assert abs(float(got_m["loss"]) - float(want_m["loss"])) <= LOSS_RTOL * float(want_m["loss"])
    for (path, g), w in zip(leaves_with_path(got_g), leaves(want_g)):
        assert _rel(g, w) <= GRAD_TOL, path

    new_s, met_s = single.step_fn(state, batch)
    new_m, met_m = tr.step_fn(mstate, batch)
    assert int(new_m.step) == 1 and int(new_m.opt.count) == 1
    assert abs(float(met_m["grad_norm"]) - float(met_s["grad_norm"])) <= 1e-5 * float(
        met_s["grad_norm"])
    for tree_m, tree_s in ((new_m.params, new_s.params), (new_m.opt.mu, new_s.opt.mu),
                           (new_m.opt.nu, new_s.opt.nu)):
        for (path, a), b in zip(leaves_with_path(tree_m), leaves(tree_s)):
            assert isinstance(a, Placed) and _rel(a, b) <= GRAD_TOL, path


@pytest.mark.parametrize("name", MESHES)
def test_f64_gradients_on_a_mesh_match_one_device(name):
    cfg = _cfg("float64")
    tc = TrainConfig(batch=4, seq_len=16)
    params = tree_map(lambda p: p.double(), Model(cfg).init(1, device="cpu"))
    batch = _batch(cfg)
    want, want_m = Trainer(cfg, tc, device="cpu").grads_of(params, batch)
    tr = Trainer(cfg, tc, mesh=_mesh(name))
    placed = tree_map(P.place, params, tr.state_shardings().params)
    got, got_m = tr.mesh_grads_of(placed, tr._microbatches(batch)[0])
    assert abs(float(got_m["loss"]) - float(want_m["loss"])) <= 1e-6
    for (path, g), w in zip(leaves_with_path(got), leaves(want)):
        assert g.dtype == torch.float64 and _rel(g, w) <= F64_TOL, path


def test_step0_loss_equals_the_reference_trainer():
    """The mesh trainer's first logged loss (the loss at the initial
    weights) against the reference's single-device ``Trainer`` on the same
    carried weights and batches."""
    cfg = _cfg()
    rcfg = ref_get_config(ARCH, smoke=True).replace(dtype="float32")
    np_params = jax.tree.map(lambda t: t.numpy(), Model(cfg).init(1, device="cpu"))
    kw = dict(KW, steps=1)
    ref = RefTrainer(rcfg, RefTrainConfig(**kw))
    ref.init_state = lambda: RefState(jnp.int32(0), jax.tree.map(jnp.asarray, np_params),
                                      radamw.init(jax.tree.map(jnp.asarray, np_params)))
    want = ref.fit(RefLoader(rcfg, kw["batch"], kw["seq_len"], seed=0))["loss"][0]
    mesh = _mesh("2x2")
    tr = Trainer(cfg, TrainConfig(**kw), mesh=mesh)
    got = tr.fit(DataLoader(cfg, kw["batch"], kw["seq_len"], mesh=mesh, seed=0),
                 params=carry_params(np_params, cfg, device="cpu"))["loss"][0]
    assert abs(got - want) <= LOSS_RTOL * abs(want)


def test_six_steps_in_cfg_dtype_end_near_the_single_device_run():
    """The reference's own check (``tests/test_multidevice.py``): six steps
    in ``cfg.dtype`` (bf16) on a mesh end within 1.5e-1 of one device."""
    cfg = get_config(ARCH, smoke=True)
    assert cfg.dtype == "bfloat16"
    kw = dict(batch=8, seq_len=32, steps=6, peak_lr=1e-3, warmup_steps=2, log_every=1)
    single = Trainer(cfg, TrainConfig(**kw), device="cpu")
    h1 = single.fit(DataLoader(cfg, 8, 32, seed=0, device="cpu"))
    mesh = _mesh("2x2")
    tr = Trainer(cfg, TrainConfig(**kw), mesh=mesh)
    h4 = tr.fit(DataLoader(cfg, 8, 32, mesh=mesh, seed=0))
    assert h4["step"] == h1["step"] == list(range(1, 7)) and np.isfinite(h4["loss"]).all()
    assert abs(h1["loss"][-1] - h4["loss"][-1]) < 1.5e-1, (h1["loss"], h4["loss"])
    assert tr.monitor.history and len(tr.monitor.history) == 6


def _trained(name="2x2", steps=2):
    cfg = _cfg()
    mesh = _mesh(name)
    tr = Trainer(cfg, TrainConfig(**dict(KW, steps=steps)), mesh=mesh)
    tr.fit(DataLoader(cfg, 4, 16, mesh=mesh, seed=0))
    return tr


def test_reshard_2x2_to_1x2_is_bit_equal():
    tr = _trained()
    small = make_mesh([CPU] * 2, model_parallel=2)
    new = reshard(tr.state, tr.state_axes(), small, tr.abstract_state(), rules="train")
    want = shardings_for_tree(tr.state_axes(), small, tr.abstract_state(), rules="train")
    for (path, a), b, sh in zip(leaves_with_path(new), leaves(tr.state), leaves(want)):
        assert torch.equal(gather(a), gather(b)), path
        if isinstance(a, Placed):
            assert a.mesh is small and a.spec == sh.spec, path
        else:
            assert a.ndim == 0, path


def test_checkpoint_saved_on_2x2_restores_onto_1x2_and_training_resumes(tmp_path):
    cfg = _cfg()
    mesh, small = _mesh("2x2"), make_mesh([CPU] * 2, model_parallel=2)
    tc = TrainConfig(**dict(KW, steps=5, checkpoint_every=3))
    tr = Trainer(cfg, tc, mesh=mesh)
    mgr = CheckpointManager(str(tmp_path))
    tr.fit(DataLoader(cfg, 4, 16, mesh=mesh, seed=0), steps=3, manager=mgr)
    assert mgr.latest_step() == 3
    resumed = Trainer(cfg, tc, mesh=small)
    state, meta = resumed.restore_or_init(mgr)
    assert meta["loader_state"] == {"step": 3, "seed": 0}
    for (path, a), b in zip(leaves_with_path(state), leaves(tr.state)):
        assert torch.equal(gather(a), gather(b)), path
        assert not isinstance(a, Placed) or a.mesh is small
    hist = resumed.fit(DataLoader(cfg, 4, 16, mesh=small, seed=0), manager=mgr)
    assert hist["step"] == [4, 5] and np.isfinite(hist["loss"]).all()
    assert int(resumed.state.step) == 5 and mgr.latest_step() == 5


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_kv_heads_split_across_positions_on_a_mesh_match_one_device(dtype):
    """6 query heads over 3 KV heads on a 2-way ``model`` axis: the KV heads
    stay replicated (3 does not split 2 ways) and position 0's query heads
    0-2 read KV heads 0, 0, 1, a group split across positions. Each
    position then reads one KV head per query head; its gradients sum
    back onto the whole ``wk``/``wv``."""
    cfg = _cfg(dtype).replace(num_heads=6, num_kv_heads=3)
    tc = TrainConfig(batch=4, seq_len=16)
    params = Model(cfg).init(1, device="cpu")
    if dtype == "float64":
        params = tree_map(lambda p: p.double(), params)
    batch = _batch(cfg)
    want, want_m = Trainer(cfg, tc, device="cpu").grads_of(params, batch)
    tr = Trainer(cfg, tc, mesh=_mesh("2x2"))
    sh = tr.state_shardings().params["layers"]["attn"]
    assert "model" in sh["wq"].spec.used() and "model" not in sh["wk"].spec.used()
    placed = tree_map(P.place, params, tr.state_shardings().params)
    got, got_m = tr.mesh_grads_of(placed, tr._microbatches(batch)[0])
    tol = (LOSS_RTOL, GRAD_TOL) if dtype == "float32" else (1e-6, F64_TOL)
    assert abs(float(got_m["loss"]) - float(want_m["loss"])) <= tol[0] * float(want_m["loss"])
    for (path, g), w in zip(leaves_with_path(got), leaves(want)):
        assert _rel(g, w) <= tol[1], path


@pytest.mark.parametrize("name", MESHES)
def test_every_stored_shard_is_on_its_position_with_its_specs_shape(name):
    """The state is stored as the train rules split it: each position holds
    only its own slice (its own copy where the spec replicates), on its
    device; the scalars stay on the lead device."""
    cfg = _cfg()
    mesh = _mesh(name)
    tr = Trainer(cfg, TrainConfig(**KW), mesh=mesh)
    state = tr.init_state()
    axes, shapes = leaves_with_path(tr.state_axes()), leaves(tr.abstract_state())
    placed = leaves(state)
    assert len(placed) == len(shapes)
    for leaf, shape in zip(placed, shapes):
        if shape.ndim == 0:
            assert not isinstance(leaf, Placed) and leaf.device == mesh.lead
            continue
        assert isinstance(leaf, Placed) and leaf.shape == shape.shape
        ptrs = set()
        for pos in mesh.positions():
            t = leaf.local(pos)
            want = tuple(n // int(np.prod([mesh.shape[a] for a in leaf.spec.axes(d)]))
                         for d, n in enumerate(shape.shape))
            assert t.device == mesh.device(pos) and tuple(t.shape) == want
            ptrs.add(t.untyped_storage().data_ptr())
        assert len(ptrs) == mesh.size           # no position shares another's memory
    spec_of = tr.state_shardings()
    for (path, leaf), sh in zip(leaves_with_path(state.params), leaves(spec_of.params)):
        model_axes = Model(cfg).logical_axes()
        node = model_axes
        for key in path:
            node = node[key]
        assert leaf.spec == sh.spec == logical_to_spec(node, mesh, tuple(leaf.shape),
                                                       rules="train"), path


def test_launcher_trains_on_the_mesh_it_is_given(capsys):
    out = launch_train.main(["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "4",
                             "--seq", "16", "--model-parallel", "2", "--device", "cpu"],
                            devices=[CPU] * 4)
    text = capsys.readouterr().out
    assert "arch=llama3.2-1b-smoke devices=4 mesh={'data': 2, 'model': 2}" in text
    assert "done: loss" in text
    tr = out["trainer"]
    assert tr.mesh is out["mesh"] and out["history"]["step"] == [1, 2]
    assert all(isinstance(leaf, Placed) for leaf in leaves(tr.state.params))
    with pytest.raises(ValueError, match="do not match"):
        launch_train.main(["--arch", ARCH, "--smoke", "--device", "cuda"], devices=[CPU] * 4)


def test_k4_launches_once_a_layer_a_position_a_microbatch(monkeypatch):
    """On the card lane (``models.attention`` told so; K4's ``_launch`` a
    counting plain version) a mesh step launches K4 layers x positions x
    microbatches times, each on its position's own heads, and calls no
    plain attention."""
    shapes = []

    def k4(q, k, v, causal):
        FA.flash_attention.launches += 1
        shapes.append(tuple(q.shape))
        with torch.no_grad():
            return FA.flash_attention_plain(q, k, v, causal=causal)

    def no_plain(*a, **kw):
        raise AssertionError("the plain attention ran on the card lane")

    monkeypatch.setattr(FA, "_launch", k4)
    monkeypatch.setattr(A, "resolve_backend", lambda backend, device: "cuda")
    monkeypatch.setattr(A, "dot_attention", no_plain)
    cfg = get_config(ARCH, smoke=True)
    mesh = _mesh("2x2")
    tc = TrainConfig(batch=4, seq_len=16, steps=2, microbatches=2, warmup_steps=1,
                     peak_lr=1e-3, log_every=1)
    tr = Trainer(cfg, tc, mesh=mesh)
    init = tr.init_state()
    before = FA.flash_attention.launches
    hist = tr.fit(DataLoader(cfg, 4, 16, mesh=mesh, seed=0))
    assert FA.flash_attention.launches - before == (2 * cfg.num_layers * mesh.size * 2
                                                    * remat.forward_runs(cfg))
    # (B/|data|/microbatches, heads/|model|, S, head_dim)
    assert set(shapes) == {(1, cfg.num_heads // 2, 16, cfg.head_dim)}
    assert np.isfinite(hist["loss"]).all()
    for (path, a), b in zip(leaves_with_path(tr.state.params), leaves(init.params)):
        assert not torch.equal(gather(a), gather(b)), path


def test_microbatches_on_a_mesh_match_one_device():
    cfg = _cfg()
    tc = TrainConfig(**dict(KW, microbatches=2))
    single = Trainer(cfg, tc, device="cpu")
    state = single.init_state(Model(cfg).init(1, device="cpu"))
    batch = _batch(cfg)
    new_s, met_s = single.step_fn(state, batch)
    tr = Trainer(cfg, tc, mesh=_mesh("2x2"))
    new_m, met_m = tr.step_fn(tr.init_state(state.params), batch)
    assert abs(float(met_m["loss"]) - float(met_s["loss"])) <= LOSS_RTOL * float(met_s["loss"])
    for (path, a), b in zip(leaves_with_path(new_m.opt.mu), leaves(new_s.opt.mu)):
        assert _rel(a, b) <= GRAD_TOL, path


def test_loader_places_batches_by_the_batch_rule():
    cfg = _cfg()
    pod = _mesh("2x2x2")
    loader = DataLoader(cfg, 8, 16, mesh=pod, seed=0)
    batch = next(loader)
    loader.close()
    want = _batch(cfg, 8, 16)
    for k, v in batch.items():
        assert v.spec == PartitionSpec(("pod", "data")) and torch.equal(gather(v), want[k])
        assert tuple(v.local((1, 0, 1)).shape) == (2, 16)
    loader = DataLoader(cfg, 6, 16, mesh=pod, seed=0)     # 6 rows: (pod, data) -> data
    assert next(loader)["tokens"].spec == PartitionSpec("data")
    loader.close()


def test_collectives_sum_in_a_fixed_order_and_differentiate():
    mesh = _mesh("2x2x2")
    gen = torch.Generator().manual_seed(0)
    full = torch.randn(8, 8, generator=gen)
    x = P.distribute(full, mesh, PartitionSpec("data", "model"))
    assert torch.equal(gather(x), full) and tuple(x.local((1, 1, 0)).shape) == (4, 4)
    moved = P.place(x, P.NamedSharding(_mesh("1x4"), PartitionSpec(None, "model")))
    assert torch.equal(gather(moved), full)
    vals = {p: torch.randn(5, generator=gen, dtype=torch.float64) for p in mesh.positions()}
    red = P.all_reduce(vals, mesh, ("pod", "data"))
    for p in mesh.positions():
        members = [(a, b, p[2]) for a in range(2) for b in range(2)]
        want = ((vals[members[0]] + vals[members[1]]) + vals[members[2]]) + vals[members[3]]
        assert torch.equal(red[p], want)
    four = {p: torch.randn(4, 3, generator=gen) for p in mesh.positions()}
    rs = P.reduce_scatter(four, mesh, "model", 0)
    assert torch.equal(rs[(0, 1, 1)], (four[(0, 1, 0)] + four[(0, 1, 1)])[2:])
    # the gradient of an all-gather is the reduce-scatter of the copies' gradients
    leaves_ = {p: t.clone().requires_grad_(True) for p, t in four.items()}
    gathered = P.all_gather(leaves_, mesh, "model", 0)
    weights = {p: torch.randn(8, 3, generator=gen) for p in mesh.positions()}
    loss = sum((gathered[p] * weights[p]).sum() for p in mesh.positions())
    grads = torch.autograd.grad(loss, [leaves_[p] for p in mesh.positions()])
    want = P.reduce_scatter(weights, mesh, "model", 0)
    for g, p in zip(grads, mesh.positions()):
        assert torch.equal(g, want[p])
    again = P.all_reduce(vals, mesh, ("pod", "data"))
    assert all(torch.equal(again[p], red[p]) for p in mesh.positions())
