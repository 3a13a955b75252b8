"""Activation rematerialisation (``models/remat.py``) on every training path.

At SMOKE size on the CPU (the plain lane), for every LM family: a step's
loss and gradients under ``remat_policy`` ``minimal`` and ``dots`` equal
``remat=False``'s bit for bit (the recompute runs the same operations on
the same inputs); what the forward keeps for the backward is ordered
``minimal`` < ``dots`` < ``none``; the units are the reference's (a block,
an encoder layer, a hybrid group) and none is wrapped without autograd.
On a 2x2 CPU mesh (a dense and a hybrid model) the same bit-equality
holds. The gradients equal the reference's ``jax.grad`` through its own
``_maybe_remat`` under the same policy, at ``test_torch_lm_model.py``'s f32
tolerances (the loss within 1e-5, each leaf within 1e-3 of its largest)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import Model as RefModel
from repro_torch.configs import get_config
from repro_torch.data.synthetic import lm_batch
from repro_torch.models import Model, remat
from repro_torch.models import transformer as T
from repro_torch.runtime.elastic import make_mesh
from repro_torch.sharding.placed import place
from repro_torch.train import TrainConfig, Trainer
from repro_torch.tree import leaves, leaves_with_path, tree_map, unflatten

ARCHS = ("llama3.2-1b", "qwen3-moe-30b-a3b", "minicpm3-4b", "falcon-mamba-7b", "zamba2-2.7b",
         "whisper-large-v3", "pixtral-12b")
POLICIES = ("minimal", "dots")
TOL_LOSS, TOL_GRAD = 1e-5, 1e-3


def _cfg(arch, policy, dtype=None):
    cfg = get_config(arch, smoke=True)
    cfg = cfg.replace(remat=False) if policy == "none" else cfg.replace(remat_policy=policy)
    return cfg if dtype is None else cfg.replace(dtype=dtype)


def _batch(cfg, rows=2, text=16):
    seq = text + (cfg.num_patches if cfg.family == "vlm" else 0)
    return {k: torch.from_numpy(v) for k, v in lm_batch(cfg, rows, seq, seed=0).items()}


def _step(cfg, params, batch):
    """(loss, per-leaf gradients, bytes the forward kept) of one step."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    (loss, _), kept = remat.measure_keep(Model(cfg).loss_fn, unflatten(params, flat), batch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss.detach(), grads, kept


@pytest.fixture(scope="module", params=ARCHS)
def steps(request):
    arch = request.param
    params = Model(_cfg(arch, "none")).init(1, device="cpu")
    batch = _batch(_cfg(arch, "none"))
    return arch, {pol: _step(_cfg(arch, pol), params, batch)
                  for pol in ("none",) + POLICIES}


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_is_bit_equal_to_no_remat(steps, policy):
    arch, out = steps
    loss, grads, _ = out[policy]
    want_loss, want, _ = out["none"]
    assert torch.equal(loss, want_loss)
    for g, w in zip(grads, want):
        assert (g is None) == (w is None) and (g is None or torch.equal(g, w)), arch


def test_kept_bytes_are_ordered_minimal_dots_none(steps):
    arch, out = steps
    kept = {pol: v[2] for pol, v in out.items()}
    assert 0 < kept["minimal"] < kept["dots"] < kept["none"], (arch, kept)


@pytest.mark.parametrize("arch", ARCHS)
def test_units_are_the_references_and_only_under_autograd(arch):
    cfg = _cfg(arch, "minimal", "float32")
    units = T.remat_units(cfg)
    assert [b for u in units for b in u] == T.block_plan(cfg)
    if cfg.family == "hybrid":
        assert len(units) == cfg.num_layers // cfg.attn_every
        assert all(len(u) == cfg.attn_every + 1 and u[-1].layer == "shared" for u in units)
    else:
        assert all(len(u) == 1 for u in units)
        assert len(units) == cfg.num_layers + (cfg.encoder_layers if cfg.family == "encdec"
                                                else 0)
    params = Model(cfg).init(1, device="cpu")
    batch = _batch(cfg)
    flat = [p.requires_grad_(True) for p in leaves(params)]
    with remat.tally_keep() as tally:
        Model(cfg).loss_fn(unflatten(params, flat), batch)
    assert tally.units == len(units) and tally.saved_bytes == 0
    with remat.tally_keep() as tally, torch.no_grad():
        Model(cfg).loss_fn(unflatten(params, flat), batch)
    assert tally.units == 0
    with remat.tally_keep() as tally:
        Model(_cfg(arch, "dots", "float32")).loss_fn(unflatten(params, flat), batch)
    assert tally.units == len(units) and tally.saved_bytes > 0
    assert remat.forward_runs(cfg) == 2 and remat.forward_runs(_cfg(arch, "none")) == 1
    with pytest.raises(ValueError, match="remat_policy='everything'"):
        remat.policy(cfg.replace(remat_policy="everything"))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-2.7b"])
def test_remat_on_a_2x2_mesh_is_bit_equal_to_no_remat(arch):
    mesh = make_mesh([torch.device("cpu")] * 4, model_parallel=2)
    params = Model(_cfg(arch, "none")).init(1, device="cpu")
    whole = _batch(_cfg(arch, "none"), rows=4)
    out = {}
    for pol in ("none",) + POLICIES:
        cfg = _cfg(arch, pol)
        tr = Trainer(cfg, TrainConfig(batch=4, seq_len=16), mesh=mesh)
        placed = tree_map(place, params, tr.state_shardings().params)
        with remat.tally_keep() as tally:
            grads, metrics = tr.mesh_grads_of(placed, tr._microbatches(whole)[0])
        assert tally.units == (0 if pol == "none" else len(T.remat_units(cfg)))
        out[pol] = (metrics["loss"], [s for leaf in leaves(grads)
                                      for s in leaf.shards.values()])
    for pol in POLICIES:
        assert torch.equal(out[pol][0], out["none"][0]), pol
        assert all(torch.equal(g, w) for g, w in zip(out[pol][1], out["none"][1])), pol


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-2.7b"])
@pytest.mark.parametrize("policy", POLICIES)
def test_gradients_match_the_references_remat(arch, policy):
    """The reference's ``jax.grad`` through ``_maybe_remat`` with the same
    policy, on the port's seed-1 weights and the same batch, f32."""
    from repro.data.synthetic import lm_batch as ref_lm_batch

    cfg = _cfg(arch, policy, "float32")
    rcfg = ref_get_config(arch, smoke=True).replace(dtype="float32", remat_policy=policy)
    assert rcfg.remat
    params = Model(cfg).init(1, device="cpu")
    batch = ref_lm_batch(rcfg, 2, 16, seed=0)
    rparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    (rloss, _), rgrads = jax.value_and_grad(RefModel(rcfg).loss_fn, has_aux=True)(
        rparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads, _ = _step(cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(loss) == pytest.approx(float(rloss), rel=TOL_LOSS, abs=TOL_LOSS)
    want = dict(leaves_with_path(jax.tree.map(np.asarray, rgrads)))
    for (path, _), g in zip(leaves_with_path(params), grads):
        w = want[path]
        g = np.zeros_like(w) if g is None else g.numpy()
        assert float(np.abs(g - w).max()) <= TOL_GRAD * max(float(np.abs(w).max()), 1e-30), path
    assert math.isfinite(float(loss))
