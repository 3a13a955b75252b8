"""Training on a mesh for the hybrid family (zamba2-2.7b: each ``model``
position runs Mamba-2's SSD on its own heads, then the one shared attention
block), the encdec family (whisper-large-v3: a non-causal encoder, the
decoder's cross-attention on each position's heads) and the vlm family
(pixtral-12b: the patches prepended, weighing 0 in the loss) on logical
meshes of ``[torch.device("cpu")] * N``, SMOKE size.

Held to the port's single-device trainer and, at step 0, to the
reference's ``Trainer``. Tolerances, f32: the loss within 1e-5 relative;
every gathered gradient and updated leaf within 5e-5 of its largest value
(observed up to 1.75e-5), but for whisper within 4e-4: on 1x4 its
encoder's gradients part by 3.19e-4 (``ffn/w_down``), where moving each
entry of the embedding table and of the frames one ulp at random parts one
device's gradients by up to 1.58e-4 (7.4e-5 on that leaf): the random
N(0, 0.02) frames and sharp random-weight attention carry last-bit
differences far, and tensor parallelism reorders f32 sums. In f64 the
same comparison holds within 2e-6, but for zamba2 within 5e-5 (observed
2.0e-5 on ``a_log``, where moving the embedding table by one ulp parts
one device's by 9.3e-6: the SSD, the dt softplus and the gated norm run in
f32 in both packages) and whisper within 1e-5 (observed 4.5e-6; its norms
and sinusoid round in f32). With every f32 part run in f64 too
(``_all_f64``) the mesh equals one device within 1e-10 (observed 2.6e-13):
what parts them above is rounding, not the mesh's arithmetic."""
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
from repro_torch.configs import get_config, list_archs
from repro_torch.data.loader import DataLoader
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import selective_scan as SS
from repro_torch.launch import train as launch_train
from repro_torch.models import Model, carry_params
from repro_torch.models.model import cross_entropy
from repro_torch.models import attention as A
from repro_torch.models import remat
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.runtime.elastic import make_mesh, reshard
from repro_torch.sharding import placed as P
from repro_torch.sharding.partition import shardings_for_tree
from repro_torch.sharding.placed import Placed, gather
from repro_torch.sharding.rules import PartitionSpec
from repro_torch.train import TrainConfig, Trainer
from repro_torch.tree import leaves, leaves_with_path, tree_map, unflatten

ARCHS = ("zamba2-2.7b", "whisper-large-v3", "pixtral-12b")
HYBRID, ENCDEC, VLM = ARCHS
CPU = torch.device("cpu")
MESHES = {"2x2": (4, 2, 1), "1x4": (4, 4, 1), "2x2x2": (8, 2, 2)}
LOSS_RTOL, EXACT_TOL = 1e-5, 1e-10
GRAD_TOL = {HYBRID: 5e-5, ENCDEC: 4e-4, VLM: 5e-5}
F64_TOL = {HYBRID: 5e-5, ENCDEC: 1e-5, VLM: 2e-6}
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


def _f64(params):
    return tree_map(lambda p: p.double(), params)


@pytest.fixture
def _all_f64(monkeypatch):
    """``Tensor.float()`` leaves an f64 tensor f64, so the models' f32
    parts (norm statistics, the SSD, softmax scores, the sinusoid, the
    cross-entropy) run in f64 as well."""
    real = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float",
                        lambda self: self if self.dtype == torch.float64 else real(self))


def _mesh_grads(cfg, name, params, batch):
    tr = Trainer(cfg, TrainConfig(batch=4, seq_len=16), mesh=_mesh(name))
    placed = tree_map(P.place, params, tr.state_shardings().params)
    return tr.mesh_grads_of(placed, tr._microbatches(batch)[0])


def _single_grads(cfg, params, batch):
    return Trainer(cfg, TrainConfig(batch=4, seq_len=16), device="cpu").grads_of(params, batch)


def _worst(got, want) -> float:
    return max(_rel(g, w) for g, w in zip(leaves(got), leaves(want)))


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_one_f32_step_on_a_mesh_matches_one_device(arch, name):
    """One step: the loss, every gathered gradient, and the updated weights
    and moments against the single-device trainer from the same weights
    and batch. On 1x4 each position holds one of the 4 heads (pixtral: its
    2 KV heads stay whole, one read a position) and zamba2's 2 of 8 SSD
    heads."""
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
        assert _rel(g, w) <= GRAD_TOL[arch], path

    new_s, _ = single.step_fn(state, batch)
    new_m, _ = tr.step_fn(mstate, batch)
    for tree_m, tree_s in ((new_m.params, new_s.params), (new_m.opt.mu, new_s.opt.mu),
                           (new_m.opt.nu, new_s.opt.nu)):
        for (path, a), b in zip(leaves_with_path(tree_m), leaves(tree_s)):
            assert isinstance(a, Placed) and _rel(a, b) <= GRAD_TOL[arch], path


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_f64_gradients_on_a_mesh_match_one_device(arch, name):
    cfg = _cfg(arch, "float64")
    params = _f64(Model(cfg).init(1, device="cpu"))
    batch = _batch(cfg)
    want, want_m = _single_grads(cfg, params, batch)
    got, got_m = _mesh_grads(cfg, name, params, batch)
    assert abs(float(got_m["loss"]) - float(want_m["loss"])) <= 1e-6
    for (path, g), w in zip(leaves_with_path(got), leaves(want)):
        assert g.dtype == torch.float64 and _rel(g, w) <= F64_TOL[arch], path


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_the_mesh_equals_one_device_with_every_part_in_f64(arch, name, _all_f64):
    """With no f32 part left the mesh's loss and gradients are one
    device's within 1e-10: the sharded arithmetic (the gated norm's sum of
    squares over ``model``, the conv's rows, the heads' slices, the
    encoder, the cross-attention, the patches) is the same function."""
    cfg = _cfg(arch, "float64")
    params = _f64(Model(cfg).init(1, device="cpu"))
    batch = _batch(cfg)
    want, want_m = _single_grads(cfg, params, batch)
    got, got_m = _mesh_grads(cfg, name, params, batch)
    assert _close(got_m["loss"], want_m["loss"], EXACT_TOL)
    for (path, g), w in zip(leaves_with_path(got), leaves(want)):
        assert _rel(g, w) <= EXACT_TOL, path


@pytest.mark.parametrize("arch", ARCHS)
def test_step0_loss_equals_the_reference_trainer(arch):
    """The mesh trainer's first logged loss against the reference's
    single-device ``Trainer`` on the same carried f32 weights and batches
    (the frontends' inputs included)."""
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


# --- Mamba-2 on a mesh --------------------------------------------------------

def _mamba2_case(model=2, seed=0):
    """zamba2 SMOKE's first Mamba-2 layer in f64, placed as the train rules
    place it on a 1 x ``model`` mesh (the stacked specs less the layer
    dim), each position's weights, and an input of 4 x 16 tokens."""
    cfg = _cfg(HYBRID, "float64")
    mesh = make_mesh([CPU] * model, model_parallel=model)
    tr = Trainer(cfg, TrainConfig(batch=4, seq_len=16), mesh=mesh)
    lp = _f64(T._layer(Model(cfg).init(1, device="cpu")["layers"], 0)["mamba"])
    specs = tree_map(lambda sh: type(sh)(sh.mesh, PartitionSpec(*tuple(sh.spec)[1:])),
                     tr.state_shardings().params["layers"]["mamba"])
    placed = tree_map(lambda t, s: P.place(t, s).map(lambda u: u.requires_grad_(True)), lp,
                      specs)
    positions = list(mesh.positions())
    w = T._position_weights({"mamba": placed}, mesh, torch.float64, positions)
    x = torch.randn(4, 16, cfg.d_model, generator=torch.Generator().manual_seed(seed),
                    dtype=torch.float64)
    return cfg, mesh, lp, placed, {p: w[p]["mamba"] for p in positions}, x


def test_mamba2_shards_split_channels_and_heads_alike(_all_f64):
    """``wz``, ``wx``, ``norm``, ``out_proj`` split over ``ssm_inner`` and
    ``wdt`` over ``ssm_heads``; ``wb``, ``wc``, the conv, ``a_log``,
    ``dt_b`` and ``d_skip`` whole. Each position's channels hold whole
    heads, in the same order: its dt, x, B and C, and its SSD's output,
    are one device's columns of those heads and channels."""
    cfg, mesh, lp, placed, w, x = _mamba2_case(model=4)
    split = {k for k, v in placed.items() if "model" in v.spec.used()}
    assert split == {"wz", "wx", "wdt", "norm", "out_proj"}
    p, di = cfg.ssm_head_dim, cfg.d_inner
    with torch.no_grad():
        xin, z, dt, a, b_mat, c_mat, _, _ = S._mamba2_inputs(lp, cfg, x)
        y, _ = S._ssd(cfg, xin, dt, a, b_mat, c_mat, lp["d_skip"])
        for pos, wp in w.items():
            d_l = wp["wx"].shape[-1]
            c0, h0, h_l = pos[1] * d_l, pos[1] * d_l // p, d_l // p
            local = S._mamba2_shard(wp, cfg, c0)
            assert local["wdt"].shape[-1] == local["a_log"].shape[0] == h_l
            xl, zl, dtl, al, bl, cl, _, _ = S._mamba2_inputs(local, cfg, x)
            torch.testing.assert_close(xl, xin[..., c0:c0 + d_l], rtol=0, atol=1e-12)
            torch.testing.assert_close(zl, z[..., c0:c0 + d_l], rtol=0, atol=1e-12)
            torch.testing.assert_close(dtl, dt[..., h0:h0 + h_l], rtol=0, atol=1e-12)
            torch.testing.assert_close(al, a[h0:h0 + h_l], rtol=0, atol=0)
            torch.testing.assert_close((bl, cl), (b_mat, c_mat), rtol=0, atol=1e-12)
            yl, _ = S._ssd(cfg, xl, dtl, al, bl, cl, local["d_skip"])
            torch.testing.assert_close(yl, y[..., c0:c0 + d_l], rtol=0, atol=1e-12)
    assert di // 4 % p == 0


def test_mamba2_conv_rows_are_the_positions_channels_and_the_shared_b_and_c():
    cfg, mesh, lp, placed, w, x = _mamba2_case(model=2)
    di, n = cfg.d_inner, cfg.ssm_state
    for pos, wp in w.items():
        c0 = pos[1] * di // 2
        local = S._mamba2_shard(wp, cfg, c0)
        rows = list(range(c0, c0 + di // 2)) + list(range(di, di + 2 * n))
        assert torch.equal(local["conv_w"], lp["conv_w"][rows])
        assert torch.equal(local["conv_b"], lp["conv_b"][rows])


def test_mamba2_heads_that_do_not_align_with_the_channels_raise():
    """64-wide heads: 2 of them, which do not split 4 ways, so ``wdt``
    stays whole while ``d_inner``'s 128 channels split into quarters of 32,
    half a head each: the forward raises rather than pair a head with
    another's channels."""
    cfg = _cfg(HYBRID).replace(ssm_head_dim=64)
    tr = Trainer(cfg, TrainConfig(batch=4, seq_len=16), mesh=_mesh("1x4"))
    assert tr.state_shardings().params["layers"]["mamba"]["wdt"].spec.axes(2) == ()
    placed = tree_map(P.place, Model(cfg).init(1, device="cpu"), tr.state_shardings().params)
    with pytest.raises(ValueError, match="whole heads"):
        tr.mesh_grads_of(placed, tr._microbatches(_batch(cfg))[0])


@pytest.mark.parametrize("planted", [False, True])
def test_mamba2_gated_norm_takes_its_mean_over_all_of_d_inner(planted, monkeypatch, _all_f64):
    """The gated RMSNorm's mean square is over all of ``d_inner``, which
    no position holds: each position's sum of squares is summed over
    ``model``. The block's output against one device's, in f64; with that
    all-reduce dropped (planted) each position normalises by its own
    channels and the output parts far past the tolerance."""
    cfg, mesh, lp, placed, w, x = _mamba2_case(model=2)
    if planted:
        real = P.all_reduce
        monkeypatch.setattr(P, "all_reduce", lambda v, m, axis: v if next(
            iter(v.values())).shape[-1] == 1 else real(v, m, axis))
    with torch.no_grad():
        want = S.apply_mamba2(lp, cfg, x)
        out = S.mamba2_mesh(w, cfg, {p: x for p in w}, mesh)
    err = max(float((o - want).abs().max() / want.abs().max()) for o in out.values())
    assert (err > 1e-3) if planted else (err <= EXACT_TOL)


def test_mamba2_whole_leaves_get_each_positions_slice_of_gradient_once(_all_f64):
    """``a_log``, ``dt_b`` and ``d_skip`` are whole on every position, which
    uses only its heads' slice of them: each position's gradient is zero
    outside that slice, and the replicas' sum (``reduce_replicas``) is one
    device's gradient."""
    cfg, mesh, lp, placed, w, x = _mamba2_case(model=2)
    flat = [t.detach().requires_grad_(True) for t in leaves(lp)]
    want = dict(zip(lp, torch.autograd.grad(S.apply_mamba2(dict(zip(lp, flat)), cfg, x).sum(),
                                            flat)))
    out = S.mamba2_mesh(w, cfg, {p: x for p in w}, mesh)
    loss = sum(o.sum() for p, o in out.items() if p[1] == 0)
    names = ("a_log", "dt_b", "d_skip")
    shards = [placed[k].shards[p] for k in names for p in mesh.positions()]
    grads = iter(torch.autograd.grad(loss, shards))
    h_l = cfg.ssm_heads // 2
    for k in names:
        assert placed[k].spec.used() == ()
        per_pos = {p: next(grads) for p in mesh.positions()}
        for p, g in per_pos.items():
            own = slice(p[1] * h_l, (p[1] + 1) * h_l)
            assert bool(g[own].ne(0).any()) and float(g.abs().sum() - g[own].abs().sum()) == 0
        total = P.reduce_replicas(Placed(mesh, placed[k].spec, placed[k].shape, per_pos))
        assert _rel(total, want[k]) <= EXACT_TOL, k


# --- The hybrid's shared block ---------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_block_plan_is_the_schedule_both_forwards_run(arch, monkeypatch):
    """``transformer.block_plan`` lists whisper's non-causal encoder blocks
    before its causal decoder blocks, zamba2's ``attn_every`` Mamba-2
    layers then the shared block once a group, and pixtral's layers; one
    device's forward and the mesh's run exactly those blocks in that order,
    each with its causality and, for whisper's decoder, its
    cross-attention; and, where the config rematerialises, the backward
    runs each remat unit's blocks again, the units in reverse order."""
    cfg = _cfg(arch)
    want = [T.Block("enc", i, False) for i in range(cfg.encoder_layers) if arch == ENCDEC]
    if arch == HYBRID:
        for g in range(T._groups(cfg)):
            want += [T.Block("dec", g * cfg.attn_every + j, True) for j in range(cfg.attn_every)]
            want.append(T.Block("dec", "shared", True))
    else:
        want += [T.Block("dec", i, True) for i in range(cfg.num_layers)]
    assert T.block_plan(cfg) == want
    assert T.block_plan(cfg, "enc") == [b for b in want if b.stream == "enc"]
    kinds = [(arch == HYBRID and b.layer != "shared", arch == ENCDEC and b.stream == "dec",
              b.causal) for b in want]
    if remat.forward_runs(cfg) == 2:
        kind = dict(zip(want, kinds))
        kinds += [kind[b] for unit in reversed(T.remat_units(cfg)) for b in unit]

    single, mesh = [], []
    real_attn, real_mamba, real_block = T._apply_attn_block, T._apply_mamba_block, T.mesh_block

    def attn(lp, c, x, positions, *, causal=True, enc_kv=None, **kw):
        single.append((False, enc_kv is not None, causal))
        return real_attn(lp, c, x, positions, causal=causal, enc_kv=enc_kv, **kw)

    def mamba(lp, c, x, **kw):
        single.append((True, False, True))
        return real_mamba(lp, c, x, **kw)

    def block(lps, c, x, pos_ids, m, *, causal=True, enc=None, backend="auto"):
        mesh.append(("mamba" in next(iter(lps.values())), enc is not None, causal))
        return real_block(lps, c, x, pos_ids, m, causal=causal, enc=enc, backend=backend)

    monkeypatch.setattr(T, "_apply_attn_block", attn)
    monkeypatch.setattr(T, "_apply_mamba_block", mamba)
    monkeypatch.setattr(T, "mesh_block", block)
    params, batch = Model(cfg).init(1, device="cpu"), _batch(cfg)
    _single_grads(cfg, params, batch)
    _mesh_grads(cfg, "2x2", params, batch)
    assert single == kinds
    assert mesh == kinds


def test_the_shared_blocks_gradient_is_summed_over_its_applications(_all_f64):
    """zamba2 SMOKE applies the one shared block after each of its 2
    groups. On one device, with a separate copy of the shared weights for
    each application, each copy's gradient is that application's; the
    mesh's gradient of the shared leaves is their sum (and neither alone)."""
    cfg = _cfg(HYBRID, "float64")
    params = _f64(Model(cfg).init(1, device="cpu"))
    batch = _batch(cfg)
    got, _ = _mesh_grads(cfg, "2x2", params, batch)
    copies = [[t.detach().requires_grad_(True) for t in leaves(params["shared"])]
              for _ in range(T._groups(cfg))]
    x, pos = T._prepare_inputs(params, cfg, batch, torch.float64)
    layers = T._layers(params["layers"], cfg.num_layers)
    for g, flat in enumerate(copies):
        for j in range(cfg.attn_every):
            x, _ = T._apply_mamba_block(layers[g * cfg.attn_every + j], cfg, x)
        x, _, _ = T._apply_attn_block(unflatten(params["shared"], flat), cfg, x, pos)
    logits = T.unembed(params, cfg, T.apply_norm(params["final_norm"], cfg, x))
    loss = cross_entropy(logits, batch["labels"], batch.get("loss_weights"))
    per_app = [torch.autograd.grad(loss, flat, retain_graph=True) for flat in copies]
    for i, (path, g) in enumerate(leaves_with_path(got["shared"])):
        total = per_app[0][i] + per_app[1][i]
        assert _rel(g, total) <= EXACT_TOL, path
        assert all(_rel(g, app[i]) > 1e-3 for app in per_app), path


# --- The encoder and the frontends' inputs ------------------------------------

@pytest.mark.parametrize("planted", [False, True])
def test_the_encoder_is_non_causal_on_the_mesh(planted, monkeypatch, _all_f64):
    """The encoder's blocks run non-causal on the mesh; with a causal
    encoder (planted) the gradients part far from one device's."""
    cfg = _cfg(ENCDEC, "float64")
    params = _f64(Model(cfg).init(1, device="cpu"))
    batch = _batch(cfg)
    want, _ = _single_grads(cfg, params, batch)
    if planted:
        real = T.mesh_block
        monkeypatch.setattr(T, "mesh_block", lambda *a, causal=True, **kw: real(
            *a, causal=True, **kw))
    got, _ = _mesh_grads(cfg, "2x2", params, batch)
    err = _worst(got, want)
    assert (err > 1e-3) if planted else (err <= EXACT_TOL)


def test_the_vlms_zero_weighted_patch_labels_do_not_reach_the_loss():
    """pixtral's labels and ``loss_weights`` cover its 8 patches (weight 0)
    and are placed over the batch axes like the tokens. Other labels at
    the patches leave the mesh's loss as it was, equal to one device's;
    weighing the patches changes it."""
    cfg = _cfg(VLM)
    params = Model(cfg).init(1, device="cpu")
    batch = _batch(cfg)
    p = cfg.num_patches
    assert batch["labels"].shape == batch["loss_weights"].shape == (4, 16)
    assert float(batch["loss_weights"][:, :p].abs().sum()) == 0
    mesh = _mesh("2x2x2")
    tr = Trainer(cfg, TrainConfig(batch=4, seq_len=16), mesh=mesh)
    placed = tree_map(P.place, params, tr.state_shardings().params)

    def mesh_loss(b):
        mb = tr._microbatches(b)[0]
        assert mb["labels"].spec == mb["loss_weights"].spec == mb["tokens"].spec
        with torch.no_grad():
            return float(tr.model.mesh_loss_fn(placed, mb, mesh)[0])

    other = dict(batch, labels=batch["labels"].clone())
    other["labels"][:, :p] = torch.randint(0, cfg.vocab_size, (4, p))
    weighed = dict(batch, loss_weights=torch.ones_like(batch["loss_weights"]))
    base = mesh_loss(batch)
    with torch.no_grad():
        single = float(Model(cfg).loss_fn(params, batch)[0])
    assert _close(base, single, LOSS_RTOL)
    assert mesh_loss(other) == base
    assert abs(mesh_loss(weighed) - base) > 1e-3


def test_the_loader_places_the_frontends_inputs_over_pod_and_data():
    pod = _mesh("2x2x2")
    for arch, key in ((ENCDEC, "enc_embeds"), (VLM, "patch_embeds")):
        cfg = _cfg(arch)
        loader = DataLoader(cfg, 8, 16, mesh=pod, seed=0)
        batch = next(loader)
        loader.close()
        want = _batch(cfg, 8, 16)
        for k, v in batch.items():
            assert v.spec == PartitionSpec(("pod", "data")) and torch.equal(gather(v), want[k]), k
        assert tuple(batch[key].local((1, 0, 1)).shape) == (2,) + tuple(want[key].shape[1:])


# --- Launches, the launcher, the rules, reshard and checkpoints -------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_k4_launches_once_an_attention_a_position_a_microbatch(arch, monkeypatch):
    """On the card lane (the models told so; K4's ``_launch`` a counting
    plain version) a mesh step launches K4 for every attention of every
    position and microbatch, each on the position's own heads: zamba2's
    shared block once a group, whisper's encoder (non-causal), decoder
    (causal) and cross-attention (non-causal over the 16 frames), pixtral's
    layers over its 8 patches and 8 text tokens. No plain attention and no
    K5 (Mamba-2's SSD is PyTorch ops in both packages)."""
    calls = []

    def k4(q, k, v, causal):
        FA.flash_attention.launches += 1
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        with torch.no_grad():
            return FA.flash_attention_plain(q, k, v, causal=causal)

    def no_plain(*a, **kw):
        raise AssertionError("a plain attention or scan ran on the card lane")

    monkeypatch.setattr(FA, "_launch", k4)
    for mod in (A, S):
        monkeypatch.setattr(mod, "resolve_backend", lambda backend, device: "cuda")
    monkeypatch.setattr(A, "dot_attention", no_plain)
    monkeypatch.setattr(S, "selective_scan", no_plain)
    cfg = get_config(arch, smoke=True)
    mesh = _mesh("2x2")
    tc = TrainConfig(batch=4, seq_len=16, steps=2, microbatches=2, warmup_steps=1,
                     peak_lr=1e-3, log_every=1)
    tr = Trainer(cfg, tc, mesh=mesh)
    before, before_k5 = FA.flash_attention.launches, SS.selective_scan.launches
    hist = tr.fit(DataLoader(cfg, 4, 16, mesh=mesh, seed=0))
    # steps x positions x microbatches x the unit's forward runs (remat: twice)
    runs = 2 * mesh.size * 2 * remat.forward_runs(cfg)
    q = (1, cfg.num_heads // 2, 16, cfg.head_dim)
    if arch == HYBRID:
        want = {(q, q, True): T._groups(cfg) * runs}
    elif arch == ENCDEC:
        want = {(q, q, False): (cfg.encoder_layers + cfg.num_layers) * runs,
                (q, q, True): cfg.num_layers * runs}
    else:
        want = {(q, q, True): cfg.num_layers * runs}
    got = {}
    for c in calls:
        got[c] = got.get(c, 0) + 1
    assert got == want
    assert FA.flash_attention.launches - before == sum(want.values())
    assert SS.selective_scan.launches == before_k5
    assert np.isfinite(hist["loss"]).all()


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


def test_no_lm_family_raises_on_a_mesh():
    mesh = _mesh("2x2")
    archs = [a for a in list_archs() if get_config(a).family in T.LM_FAMILIES]
    assert {get_config(a).family for a in archs} == set(T.LM_FAMILIES)
    for arch in archs:
        Trainer(get_config(arch, smoke=True), TrainConfig(batch=4, seq_len=16), mesh=mesh)


@pytest.mark.parametrize("arch", ARCHS)
def test_no_leaf_splits_a_dim_over_model_and_another_axis(arch):
    """``transformer._position_weights`` keeps ``model``'s slices and
    gathers the other axes: no leaf of these families (``encoder/*``,
    ``layers/cross``, ``layers/ln_x``, ``shared/*``, Mamba-2's 12) may
    split one dim over both, on any of the meshes."""
    cfg = _cfg(arch)
    for name in MESHES:
        tr = Trainer(cfg, TrainConfig(batch=4, seq_len=16), mesh=_mesh(name))
        for path, sh in leaves_with_path(tr.state_shardings()):
            for dim in range(len(sh.spec)):
                axes = sh.spec.axes(dim)
                assert axes == ("model",) or "model" not in axes, (name, path)


def _trained(arch, steps=2):
    cfg = _cfg(arch)
    mesh = _mesh("2x2")
    tr = Trainer(cfg, TrainConfig(**dict(KW, steps=steps)), mesh=mesh)
    tr.fit(DataLoader(cfg, 4, 16, mesh=mesh, seed=0))
    return tr


@pytest.mark.parametrize("arch", ARCHS)
def test_reshard_2x2_to_1x2_is_bit_equal(arch):
    """Every leaf of the trained state, the hybrid's ``shared`` subtree and
    whisper's ``encoder`` among them."""
    tr = _trained(arch)
    small = make_mesh([CPU] * 2, model_parallel=2)
    new = reshard(tr.state, tr.state_axes(), small, tr.abstract_state(), rules="train")
    want = shardings_for_tree(tr.state_axes(), small, tr.abstract_state(), rules="train")
    paths = {"/".join(p) for p, _ in leaves_with_path(new.params)}
    assert {HYBRID: "shared/attn/wq", ENCDEC: "encoder/layers/attn/wq",
            VLM: "layers/attn/wq"}[arch] in paths
    for (path, a), b, sh in zip(leaves_with_path(new), leaves(tr.state), leaves(want)):
        assert torch.equal(gather(a), gather(b)), path
        if isinstance(a, Placed):
            assert a.mesh is small and a.spec == sh.spec, path
        else:
            assert a.ndim == 0, path


def test_a_hybrid_checkpoint_saved_on_2x2_restores_onto_1x2_and_resumes(tmp_path):
    cfg = _cfg(HYBRID)
    mesh, small = _mesh("2x2"), make_mesh([CPU] * 2, model_parallel=2)
    tc = TrainConfig(**dict(KW, steps=4, checkpoint_every=2))
    tr = Trainer(cfg, tc, mesh=mesh)
    mgr = CheckpointManager(str(tmp_path))
    tr.fit(DataLoader(cfg, 4, 16, mesh=mesh, seed=0), steps=2, manager=mgr)
    resumed = Trainer(cfg, tc, mesh=small)
    state, meta = resumed.restore_or_init(mgr)
    assert meta["loader_state"] == {"step": 2, "seed": 0}
    for (path, a), b in zip(leaves_with_path(state), leaves(tr.state)):
        assert torch.equal(gather(a), gather(b)), path
        assert not isinstance(a, Placed) or a.mesh is small
    hist = resumed.fit(DataLoader(cfg, 4, 16, mesh=small, seed=0), manager=mgr)
    assert hist["step"] == [3, 4] and np.isfinite(hist["loss"]).all()
