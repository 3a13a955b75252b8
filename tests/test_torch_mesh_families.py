"""Training on a mesh for the ssm family (falcon-mamba-7b: Mamba-1, each
``model`` position on its own ``ssm_inner`` channels), MLA (minicpm3-4b:
the query latent gathered over ``model`` before ``q_norm``, each position
on its own heads) and the moe family (qwen3-moe-30b-a3b, phi3.5-moe-42b-
a6.6b: experts split over ``model``, routing groups of the whole
microbatch) on logical meshes of ``[torch.device("cpu")] * N``, SMOKE size.

Held to the port's single-device trainer and, at step 0, to the
reference's ``Trainer``. Tolerances, f32: the loss within 1e-5 relative;
every gathered gradient and updated leaf within 5e-5 of its largest value
(observed up to 2.8e-5, phi3.5-moe's router, where moving the embeddings by
one ulp moves the single-device gradients by 7.7e-5, and minicpm3-4b's by
3.1e-5: tensor parallelism reorders f32 sums as such a change does). In
f64 the same comparison holds within 2e-6 (observed 4.9e-7: the model's
f32 parts still round)."""
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
from repro_torch.configs import get_config
from repro_torch.data.loader import DataLoader
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import selective_scan as SS
from repro_torch.launch import train as launch_train
from repro_torch.models import Model, carry_params
from repro_torch.models import attention as A
from repro_torch.models import remat
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.runtime.elastic import make_mesh
from repro_torch.sharding import placed as P
from repro_torch.sharding.placed import Placed, gather
from repro_torch.train import TrainConfig, Trainer
from repro_torch.tree import leaves, leaves_with_path, tree_map

ARCHS = ("falcon-mamba-7b", "minicpm3-4b", "qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b")
MOE_ARCHS = ARCHS[2:]
CPU = torch.device("cpu")
MESHES = {"2x2": (4, 2, 1), "1x4": (4, 4, 1), "2x2x2": (8, 2, 2)}
LOSS_RTOL, GRAD_TOL, F64_TOL = 1e-5, 5e-5, 2e-6
KW = dict(batch=4, seq_len=16, steps=6, peak_lr=5e-3, warmup_steps=2, log_every=1)


def _mesh(name):
    n, model, pods = MESHES[name]
    return make_mesh([CPU] * n, model_parallel=model, pods=pods)


def _cfg(arch, dtype="float32"):
    return get_config(arch, smoke=True).replace(dtype=dtype)


def _batch(cfg, batch=4, seq=16):
    loader = DataLoader(cfg, batch, seq, seed=0, device="cpu")
    out = next(loader)
    loader.close()
    return out


def _rel(got, want) -> float:
    got, want = gather(got).double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _close(got, want, rtol) -> bool:
    return abs(float(got) - float(want)) <= rtol * abs(float(want))


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_one_f32_step_on_a_mesh_matches_one_device(arch, name):
    """One step: the loss (a moe model's ``moe_aux`` and ``moe_z`` with it),
    every gathered gradient, and the updated weights and moments against
    the single-device trainer from the same weights and batch. On 1x4
    qwen3-moe's 2 KV heads stay whole, and phi3.5-moe's 4 experts split 4
    ways, one a position."""
    cfg, tc = _cfg(arch), TrainConfig(**KW)
    single = Trainer(cfg, tc, device="cpu")
    state = single.init_state(Model(cfg).init(1, device="cpu"))
    batch = _batch(cfg)
    tr = Trainer(cfg, tc, mesh=_mesh(name))
    mstate = tr.init_state(state.params)

    want_g, want_m = single.grads_of(state.params, batch)
    got_g, got_m = tr.mesh_grads_of(mstate.params, tr._microbatches(batch)[0])
    assert set(got_m) == set(want_m)
    for k in want_m:
        assert _close(got_m[k], want_m[k], LOSS_RTOL), k
    for (path, g), w in zip(leaves_with_path(got_g), leaves(want_g)):
        assert _rel(g, w) <= GRAD_TOL, path

    new_s, _ = single.step_fn(state, batch)
    new_m, _ = tr.step_fn(mstate, batch)
    for tree_m, tree_s in ((new_m.params, new_s.params), (new_m.opt.mu, new_s.opt.mu),
                           (new_m.opt.nu, new_s.opt.nu)):
        for (path, a), b in zip(leaves_with_path(tree_m), leaves(tree_s)):
            assert isinstance(a, Placed) and _rel(a, b) <= GRAD_TOL, path


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_f64_gradients_on_a_mesh_match_one_device(arch, name):
    cfg = _cfg(arch, "float64")
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


@pytest.mark.parametrize("arch", ARCHS)
def test_step0_loss_equals_the_reference_trainer(arch):
    """The mesh trainer's first logged loss (a moe model's aux terms
    included) against the reference's single-device ``Trainer`` on the
    same carried f32 weights and batches."""
    cfg = _cfg(arch)
    rcfg = ref_get_config(arch, smoke=True).replace(dtype="float32")
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


@pytest.mark.parametrize("group", ["spans the shards", "divides the shards"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_routing_groups_are_the_microbatchs(arch, group):
    """Groups of the microbatch's 64 tokens span both batch shards of 32 (2x2
    mesh), or groups of 16 divide them; capacity factor 0.5 drops tokens.
    The MoE on the mesh (``moe.moe_mesh``, from one device's input split
    into its batch shards) keeps exactly one device's (token, expert)
    slots, and its output and aux losses match; a whole mesh step logs the
    same slots in every layer, and its aux losses match one device's. Under
    remat the backward runs each layer's MoE again (the layers in reverse
    order) and logs the same slots again."""
    cfg = _cfg(arch).replace(moe_group_size=64 if group == "spans the shards" else 16,
                             moe_capacity_factor=0.5)
    mesh = _mesh("2x2")
    tr = Trainer(cfg, TrainConfig(batch=4, seq_len=16), mesh=mesh)
    params = Model(cfg).init(1, device="cpu")
    lp = T._layer(params["layers"], 0)["ffn"]
    x = torch.randn(4, 16, cfg.d_model, generator=torch.Generator().manual_seed(0))
    with M.record_routing() as one:
        want, want_aux = M.apply_moe(lp, cfg, x)
    specs = tree_map(lambda sh: type(sh)(sh.mesh, P.PartitionSpec(*tuple(sh.spec)[1:])),
                     tr.state_shardings().params["layers"]["ffn"])
    placed = tree_map(P.place, lp, specs)
    active = list(mesh.positions())
    w = T._position_weights({"ffn": placed}, mesh, torch.float32, active)
    xs = {p: x[2 * p[0]:2 * p[0] + 2] for p in active}
    with M.record_routing() as got:
        out, aux = M.moe_mesh({p: w[p]["ffn"] for p in active}, cfg, xs, mesh)
    (lg1, idx1, kept1), = one
    lg2, idx2, kept2 = (torch.cat(t) for t in zip(*got))
    assert not bool(kept1.all())                                   # the capacity dropped some
    assert torch.equal(idx2, idx1) and torch.equal(kept2, kept1)
    torch.testing.assert_close(lg2, lg1, rtol=0, atol=1e-6)
    for p in active:
        torch.testing.assert_close(out[p], want[2 * p[0]:2 * p[0] + 2], rtol=1e-5, atol=1e-6)
    for k in want_aux:
        assert _close(aux[k], want_aux[k], 1e-6), k

    batch = _batch(cfg)
    with M.record_routing() as one:
        _, want_m = Trainer(cfg, tr.tc, device="cpu").grads_of(params, batch)
    with M.record_routing() as got:
        _, got_m = tr.mesh_grads_of(tree_map(P.place, params, tr.state_shardings().params),
                                    tr._microbatches(batch)[0])
    n = cfg.num_layers
    order = list(range(n)) + list(reversed(range(n)))[:n * (remat.forward_runs(cfg) - 1)]
    per_layer = len(got) // len(order)
    assert len(one) == len(order) and per_layer * len(order) == len(got)
    for j, i in enumerate(order):
        mesh_kept = torch.cat([k for _, _, k in got[j * per_layer:(j + 1) * per_layer]])
        assert torch.equal(mesh_kept, one[i][2]) and torch.equal(one[j][2], one[i][2]), (j, i)
    for k in ("moe_aux", "moe_z"):
        assert _close(got_m[k], want_m[k], LOSS_RTOL), k


def test_mamba1_pairs_each_positions_own_x_and_z_channels():
    """On a 1x2 mesh ``in_proj``'s stored split puts every ``x`` column at
    position 0 and every ``z`` column at position 1; each position must
    gate its own channels of ``x`` by the same channels of ``z``. The
    block's output and gradients against one device, in f64."""
    cfg = _cfg("falcon-mamba-7b", "float64")
    tc = TrainConfig(batch=4, seq_len=16)
    mesh = make_mesh([CPU] * 2, model_parallel=2)
    tr = Trainer(cfg, tc, mesh=mesh)
    spec = tr.state_shardings().params["layers"]["mamba"]["in_proj"].spec
    assert spec.axes(2) == ("model",)
    params = tree_map(lambda p: p.double(), Model(cfg).init(1, device="cpu"))
    batch = _batch(cfg)
    want, want_m = Trainer(cfg, tc, device="cpu").grads_of(params, batch)
    placed = tree_map(P.place, params, tr.state_shardings().params)
    got, got_m = tr.mesh_grads_of(placed, tr._microbatches(batch)[0])
    assert abs(float(got_m["loss"]) - float(want_m["loss"])) <= 1e-6
    for (path, g), w in zip(leaves_with_path(got), leaves(want)):
        assert _rel(g, w) <= F64_TOL, path


@pytest.mark.parametrize("arch", ARCHS)
def test_no_leaf_splits_a_dim_over_model_and_another_axis(arch):
    """``transformer._position_weights`` keeps ``model``'s slices and
    gathers the other axes: no leaf of these families may split one dim
    over both, on any of the meshes."""
    cfg = _cfg(arch)
    for name in MESHES:
        tr = Trainer(cfg, TrainConfig(batch=4, seq_len=16), mesh=_mesh(name))
        for path, sh in leaves_with_path(tr.state_shardings()):
            for dim in range(len(sh.spec)):
                axes = sh.spec.axes(dim)
                assert axes == ("model",) or "model" not in axes, (name, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_the_family_on_a_2x2_mesh(arch, capsys):
    out = launch_train.main(["--arch", arch, "--smoke", "--steps", "2", "--batch", "4",
                             "--seq", "16", "--model-parallel", "2", "--device", "cpu"],
                            devices=[CPU] * 4)
    assert "mesh={'data': 2, 'model': 2}" in capsys.readouterr().out
    tr = out["trainer"]
    assert tr.mesh is out["mesh"] and out["history"]["step"] == [1, 2]
    assert np.isfinite(out["history"]["loss"]).all()
    init = Model(tr.cfg).init(0, device="cpu")
    for (path, a), b in zip(leaves_with_path(tr.state.params), leaves(init)):
        assert isinstance(a, Placed) and not torch.equal(gather(a), b), path


@pytest.mark.parametrize("arch", ARCHS)
def test_kernels_launch_once_a_layer_a_position_a_microbatch(arch, monkeypatch):
    """On the card lane (the models told so; K4's and K5's ``_launch``
    counting plain versions) a mesh step launches K5 (ssm) or K4 (MLA,
    moe) layers x positions x microbatches times, each on its position's
    own channels or heads, and calls no plain scan or attention."""
    shapes = []

    def k4(q, k, v, causal):
        FA.flash_attention.launches += 1
        shapes.append(tuple(q.shape))
        with torch.no_grad():
            return FA.flash_attention_plain(q, k, v, causal=causal)

    def k5(x, dt, b, c, a, **kw):
        SS.selective_scan.launches += 1
        shapes.append(tuple(x.shape) + (b.shape[-1],))
        with torch.no_grad():
            return SS.selective_scan_plain(x, dt, b, c, a, **kw)

    def no_plain(*a, **kw):
        raise AssertionError("a plain attention or scan ran on the card lane")

    monkeypatch.setattr(FA, "_launch", k4)
    monkeypatch.setattr(SS, "_launch", k5)
    for mod in (A, S):
        monkeypatch.setattr(mod, "resolve_backend", lambda backend, device: "cuda")
    monkeypatch.setattr(A, "dot_attention", no_plain)
    monkeypatch.setattr(S, "selective_scan", no_plain)
    cfg = get_config(arch, smoke=True)
    mesh = _mesh("2x2")
    tc = TrainConfig(batch=4, seq_len=16, steps=2, microbatches=2, warmup_steps=1,
                     peak_lr=1e-3, log_every=1)
    tr = Trainer(cfg, tc, mesh=mesh)
    counter = SS.selective_scan if cfg.family == "ssm" else FA.flash_attention
    other = FA.flash_attention if cfg.family == "ssm" else SS.selective_scan
    before, before_other = counter.launches, other.launches
    hist = tr.fit(DataLoader(cfg, 4, 16, mesh=mesh, seed=0))
    runs = remat.forward_runs(cfg)      # the unit's forward again in the backward
    assert counter.launches - before == 2 * cfg.num_layers * mesh.size * 2 * runs
    assert other.launches == before_other
    # (B/|data|/microbatches, the position's heads or channels, S, D or N)
    if cfg.family == "ssm":
        want = (1, 16, cfg.d_inner // 2, cfg.ssm_state)
    elif cfg.attn_type == "mla":
        want = (1, cfg.num_heads // 2, 16, cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    else:
        want = (1, cfg.num_heads // 2, 16, cfg.head_dim)
    assert set(shapes) == {want}
    assert np.isfinite(hist["loss"]).all()


def test_experts_that_do_not_split_leave_model_to_the_mlp_columns():
    """6 experts do not split 4 ways: the rules give ``model`` to the
    experts' ``mlp`` dim instead, every position runs all 6 experts on its
    quarter of the columns, and the partial outputs are summed over
    ``model``. f64, against one device."""
    cfg = _cfg("qwen3-moe-30b-a3b", "float64").replace(num_experts=6)
    tc = TrainConfig(batch=4, seq_len=16)
    tr = Trainer(cfg, tc, mesh=_mesh("1x4"))
    spec = tr.state_shardings().params["layers"]["ffn"]["w_up"].spec
    assert spec.axes(1) == () and spec.axes(3) == ("model",)
    params = tree_map(lambda p: p.double(), Model(cfg).init(1, device="cpu"))
    batch = _batch(cfg)
    want, want_m = Trainer(cfg, tc, device="cpu").grads_of(params, batch)
    got, got_m = tr.mesh_grads_of(tree_map(P.place, params, tr.state_shardings().params),
                                  tr._microbatches(batch)[0])
    for k in want_m:
        assert abs(float(got_m[k]) - float(want_m[k])) <= 1e-6 * abs(float(want_m[k])), k
    for (path, g), w in zip(leaves_with_path(got), leaves(want)):
        assert _rel(g, w) <= F64_TOL, path
