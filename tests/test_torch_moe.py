"""The port's MoE FFN against ``repro.models.moe.apply_moe`` on the same
numpy inputs and weights, at both MoE archs' smoke shapes: the output within
1e-5 (abs + rel, f32), the auxiliary losses within 1e-6, and the dispatch
exactly equal: the chosen experts, each expert's token slots (``ids``),
their occupancy (``valid``) and the dropped (token, slot) pairs.

The reference keeps its dispatch inside ``apply_moe``; the test reads it
from the ``jnp.take_along_axis`` calls that ``apply_moe`` makes, in their
order there (the sort of the chosen experts, the queue starts, the gates,
the expert gather over ``ids``, each pair's queue position), by handing the
reference module a ``jnp`` that records them."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import moe as RM
from repro_torch.configs import get_config
from repro_torch.models import moe as M

ARCHS = ("qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b")
TOL = 1e-5        # f32 output, abs + rel
AUX_TOL = 1e-6


def _cfgs(arch):
    return (get_config(arch, smoke=True).replace(dtype="float32"),
            ref_get_config(arch, smoke=True).replace(dtype="float32"))


def _params(cfg, seed=0, zero_router=False):
    rng = np.random.default_rng(seed)
    p = {k: (rng.normal(0, 1, s.shape) / np.sqrt(s.shape[-2])).astype(np.float32)
         for k, s in M.moe_params(cfg).items()}
    if zero_router:
        p["router"] = np.zeros_like(p["router"])
    return p


def _x(cfg, shape, seed=1, common=0.0):
    """Tokens (B, S, d); ``common`` adds one shared direction to every
    token, so that they route alike and overflow their experts."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, shape + (cfg.d_model,))
    x += common * rng.normal(0, 1, cfg.d_model)
    return x.astype(np.float32)


def _reference(monkeypatch, rcfg, params, x):
    """The reference's output, aux losses and dispatch, read from its
    ``take_along_axis`` calls."""
    calls = []

    def take_along_axis(arr, indices, axis):
        out = jnp.take_along_axis(arr, indices, axis=axis)
        calls.append((np.asarray(arr), np.asarray(indices), np.asarray(out)))
        return out

    proxy = types.SimpleNamespace(**{n: getattr(jnp, n) for n in dir(jnp)
                                     if not n.startswith("__")})
    proxy.take_along_axis = take_along_axis
    monkeypatch.setattr(RM, "jnp", proxy)
    out, aux = RM.apply_moe({k: jnp.asarray(v) for k, v in params.items()}, rcfg,
                            jnp.asarray(x))
    monkeypatch.undo()
    e, k = rcfg.num_experts, rcfg.num_experts_per_tok
    flat_e = calls[0][0]                                   # (g, gs*k) chosen experts
    g = flat_e.shape[0]
    gs = flat_e.shape[1] // k
    ids = calls[3][1].reshape(g, e, -1)                    # the gather over ids
    cap = ids.shape[-1]
    pos = calls[4][2].reshape(g, gs, k)                    # each pair's queue position
    gates = calls[2][0].reshape(g, gs, k)
    valid = np.zeros((g, e, cap), np.float32)
    gate_ec = np.zeros((g, e, cap), np.float32)
    for gi, t, kk in zip(*np.nonzero(pos < cap)):
        ex = flat_e[gi, t * k + kk]
        valid[gi, ex, pos[gi, t, kk]] = 1.0
        gate_ec[gi, ex, pos[gi, t, kk]] = gates[gi, t, kk]
    return dict(out=np.asarray(out), aux={n: float(v) for n, v in aux.items()},
                idx=flat_e.reshape(g, gs, k), ids=ids, valid=valid, gate_ec=gate_ec,
                dropped=pos >= cap, cap=cap)


def _port(cfg, params, x):
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    xt = torch.from_numpy(x)
    out, aux = M.apply_moe(tp, cfg, xt)
    t = x.shape[0] * x.shape[1]
    gs = min(cfg.moe_group_size, t)
    _, _, gates, idx = M.route(tp, cfg, xt.reshape(t // gs, gs, cfg.d_model))
    dp = M.dispatch(idx, gates, M._capacity(gs, cfg), cfg.num_experts, xt.dtype)
    return dict(out=out.numpy(), aux={n: float(v) for n, v in aux.items()}, idx=idx.numpy(),
                ids=dp.ids.numpy(), valid=dp.valid.numpy(), gate_ec=dp.gate_ec.numpy(),
                dropped=(~dp.within).numpy(), cap=dp.ids.shape[-1])


def _compare(got, want):
    assert got["cap"] == want["cap"]
    np.testing.assert_array_equal(got["idx"], want["idx"])
    np.testing.assert_array_equal(got["dropped"], want["dropped"])
    np.testing.assert_array_equal(got["valid"], want["valid"])
    # An empty slot holds token 0 in both; compare the tokens of every slot.
    np.testing.assert_array_equal(got["ids"], want["ids"])
    np.testing.assert_allclose(got["gate_ec"], want["gate_ec"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["out"], want["out"], rtol=TOL, atol=TOL)
    assert set(got["aux"]) == set(want["aux"]) == {"moe_aux", "moe_z"}
    for n in want["aux"]:
        assert abs(got["aux"][n] - want["aux"][n]) <= AUX_TOL * (1 + abs(want["aux"][n])), n


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(2, 16), (1, 32), (1, 5)], ids=["2x16", "1x32", "1x5"])
def test_apply_moe_matches_reference(monkeypatch, arch, shape):
    """One routing group (T <= moe_group_size = 32 at smoke)."""
    cfg, rcfg = _cfgs(arch)
    params, x = _params(cfg), _x(cfg, shape)
    got, want = _port(cfg, params, x), _reference(monkeypatch, rcfg, params, x)
    assert got["idx"].shape[0] == 1
    _compare(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_several_groups_match_reference(monkeypatch, arch):
    cfg, rcfg = _cfgs(arch)
    params, x = _params(cfg, seed=2), _x(cfg, (4, 24), seed=3)
    got, want = _port(cfg, params, x), _reference(monkeypatch, rcfg, params, x)
    assert got["idx"].shape[:2] == (3, 32)
    _compare(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_overflowing_experts_drop_in_token_order_as_reference(monkeypatch, arch):
    """Tokens that share a strong direction route alike, so their experts'
    queues outgrow the capacity: the pairs past it are dropped, in token
    order, exactly as the reference drops them."""
    cfg, rcfg = _cfgs(arch)
    params, x = _params(cfg, seed=4), _x(cfg, (2, 32), seed=5, common=4.0)
    got, want = _port(cfg, params, x), _reference(monkeypatch, rcfg, params, x)
    _compare(got, want)
    assert got["dropped"].any() and not got["dropped"].all()
    # token order: within each group an expert keeps its first `cap` pairs
    e = got["idx"]
    for gi in range(e.shape[0]):
        for ex in range(cfg.num_experts):
            hits = np.argwhere(e[gi] == ex)                    # (token, slot), token order
            kept = ~got["dropped"][gi][tuple(hits.T)]
            assert kept.tolist() == [i < got["cap"] for i in range(len(hits))]


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_router_ties_pick_the_lowest_experts_as_reference(monkeypatch, arch):
    """A zero router makes every probability equal: the reference's top_k
    takes experts 0..k-1 for every token, and so must the port."""
    cfg, rcfg = _cfgs(arch)
    params, x = _params(cfg, seed=6, zero_router=True), _x(cfg, (2, 16), seed=7)
    got, want = _port(cfg, params, x), _reference(monkeypatch, rcfg, params, x)
    k = cfg.num_experts_per_tok
    assert (got["idx"] == np.arange(k)).all()
    _compare(got, want)
    assert got["dropped"].any()          # 32 tokens on k experts overflow the capacity


@pytest.mark.parametrize("arch", ARCHS)
def test_groups_that_do_not_divide_the_tokens_raise(arch):
    cfg, rcfg = _cfgs(arch)
    params, x = _params(cfg), _x(cfg, (1, 40))           # 40 tokens, groups of 32
    with pytest.raises(ValueError, match="must divide"):
        M.apply_moe({k: torch.from_numpy(v) for k, v in params.items()}, cfg,
                    torch.from_numpy(x))
    with pytest.raises(AssertionError):
        RM.apply_moe({k: jnp.asarray(v) for k, v in params.items()}, rcfg, jnp.asarray(x))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tokens", [1, 5, 32, 4096, 5000])
def test_capacity_and_params_match_reference(arch, tokens):
    cfg, rcfg = _cfgs(arch)
    assert M._capacity(tokens, cfg) == RM._capacity(tokens, rcfg)
    full, rfull = get_config(arch), ref_get_config(arch)
    assert M._capacity(tokens, full) == RM._capacity(tokens, rfull)
    assert {k: tuple(s) for k, s in M.moe_params(cfg).items()} == \
        {k: tuple(s) for k, s in RM.moe_params(rcfg).items()}


def test_record_routing_logs_each_call():
    cfg, _ = _cfgs(ARCHS[0])
    params = {k: torch.from_numpy(v) for k, v in _params(cfg).items()}
    x = torch.from_numpy(_x(cfg, (2, 16)))
    with M.record_routing() as log:
        M.apply_moe(params, cfg, x)
        M.apply_moe(params, cfg, x[:1])
    M.apply_moe(params, cfg, x)                              # outside: not logged
    assert [tuple(lg.shape) for lg, _, _ in log] == [(32, cfg.num_experts), (16, cfg.num_experts)]
    _, _, _, idx = M.route(params, cfg, x.reshape(1, 32, cfg.d_model))
    assert torch.equal(log[0][1], idx.reshape(32, -1))
    assert not M._LOGS
