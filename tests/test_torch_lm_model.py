"""The port's dense, moe and ssm models against ``repro.models.Model`` with
the same weights (carried by ``carry_params``) at the smoke configs of every
dense arch (minicpm3-4b with MLA among them), both MoE archs and
falcon-mamba-7b: forward logits (and a moe model's auxiliary losses), and
prefill + token-by-token decode logits, at the reference's own tolerances
(``tests/test_decode_consistency.py``: 3e-4 for prefill, 5e-4 for decode)
or tighter; the configs and parameter counts equal the reference's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import Model as RefModel
from repro_torch.configs import get_config, list_archs
from repro_torch.models import Model, carry_params

DENSE = ("llama3.2-1b", "olmo-1b", "glm4-9b")
MOE_MLA = ("qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b", "minicpm3-4b")
SSM = "falcon-mamba-7b"
TOL_FORWARD = 1e-4     # f32, sums in another order over a 2-layer smoke model
TOL_AUX = 1e-6         # the MoE's auxiliary losses, abs + rel
TOL_PREFILL = 3e-4     # tests/test_decode_consistency.py
TOL_DECODE = 5e-4


@pytest.fixture(scope="module", params=DENSE + MOE_MLA)
def carried(request):
    arch = request.param
    rcfg = ref_get_config(arch, smoke=True).replace(dtype="float32")
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    rmodel = RefModel(rcfg)
    rparams = rmodel.init(jax.random.key(1))
    params = carry_params(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    return cfg, Model(cfg), params, rcfg, rmodel, rparams


def _tokens(cfg, shape, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("arch", DENSE + (SSM,) + MOE_MLA)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_and_param_count_match_reference(arch, smoke):
    cfg, rcfg = get_config(arch, smoke=smoke), ref_get_config(arch, smoke=smoke)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(rcfg, f.name), f.name
    assert Model(cfg).param_count() == RefModel(rcfg).param_count()
    assert arch in list_archs()


@pytest.mark.parametrize("arch,layers,count", [
    ("qwen3-moe-30b-a3b", 48, 30_532_122_624), ("qwen3-moe-30b-a3b", 24, 15_577_227_264),
    ("phi3.5-moe-42b-a6.6b", 32, 41_872_793_600), ("phi3.5-moe-42b-a6.6b", 8, 10_665_205_760),
    ("minicpm3-4b", 62, 4_261_902_848)])
def test_full_width_param_counts_at_the_cards_depths(arch, layers, count):
    """The depths chip_smoke.py runs on one 80 GB card in f32 (the MoE archs
    do not fit whole: 122.1 GB and 167.5 GB), counted as the reference counts."""
    cfg = get_config(arch).replace(num_layers=layers)
    assert Model(cfg).param_count() == count == RefModel(
        ref_get_config(arch).replace(num_layers=layers)).param_count()


def test_carry_params_keeps_names_shapes_and_values(carried):
    cfg, model, params, _rcfg, _rmodel, rparams = carried
    ref = jax.tree_util.tree_flatten_with_path(rparams)[0]
    assert ref
    for path, leaf in ref:
        node = params
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert params["layers"]["attn"]["wo"].shape[0] == cfg.num_layers
    bad = jax.tree.map(np.asarray, rparams)
    bad["layers"]["attn"]["wo"] = bad["layers"]["attn"]["wo"][:, :1]
    with pytest.raises(ValueError, match="shape"):
        carry_params(bad, cfg, device="cpu")
    bad = jax.tree.map(np.asarray, rparams)
    bad["extra"] = np.zeros(3)
    with pytest.raises(KeyError, match="extra"):
        carry_params(bad, cfg, device="cpu")


def test_forward_matches_reference(carried):
    cfg, model, params, _rcfg, rmodel, rparams = carried
    tokens = _tokens(cfg, (2, 12))
    want, want_aux = rmodel.forward(rparams, {"tokens": jnp.asarray(tokens)})
    got, aux = model.forward(params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_FORWARD, atol=TOL_FORWARD)
    assert set(aux) == set(want_aux) == ({"moe_aux", "moe_z"} if cfg.family == "moe" else set())
    for name, v in aux.items():
        assert v.shape == () and abs(float(v) - float(want_aux[name])) <= TOL_AUX * (
            1 + abs(float(want_aux[name]))), name


def test_prefill_and_decode_match_reference(carried):
    cfg, model, params, _rcfg, rmodel, rparams = carried
    tot, plen = 12, 8
    tokens = _tokens(cfg, (2, tot), seed=3)
    rcache = rmodel.init_cache(2, 32, dtype=jnp.float32)
    cache = model.init_cache(2, 32, dtype=torch.float32, device="cpu")
    rl, rcache = rmodel.prefill(rparams, {"tokens": jnp.asarray(tokens[:, :plen])}, rcache)
    lp, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens[:, :plen])}, cache)
    np.testing.assert_allclose(lp.numpy(), np.asarray(rl), rtol=TOL_PREFILL, atol=TOL_PREFILL)
    for i in range(plen, tot):
        step = tokens[:, i:i + 1]
        rd, rcache = rmodel.decode_step(rparams, rcache, jnp.asarray(step), jnp.int32(i))
        ld, cache = model.decode_step(params, cache, torch.from_numpy(step), i)
        np.testing.assert_allclose(ld.numpy(), np.asarray(rd), rtol=TOL_DECODE, atol=TOL_DECODE)
    assert set(cache["layers"]) == set(rcache["layers"])
    for n in cache["layers"]:
        np.testing.assert_allclose(cache["layers"][n].numpy(), np.asarray(rcache["layers"][n]),
                                   rtol=TOL_DECODE, atol=TOL_DECODE)


def test_prefill_decode_matches_own_forward(carried):
    """The port's own serving path reproduces its full forward (the
    reference's test_prefill_decode_matches_forward, which makes a moe model
    dropless for it: prefill, decode and forward route in groups of
    different sizes), with per-slot decode indices equal to scalar ones."""
    cfg, model, params = carried[:3]
    if cfg.family == "moe":
        cfg = cfg.replace(moe_capacity_factor=float(cfg.num_experts))  # dropless
        model = Model(cfg)
    tot, plen = 12, 8
    tokens = torch.from_numpy(_tokens(cfg, (2, tot), seed=4))
    full, _ = model.forward(params, {"tokens": tokens})
    cache = model.init_cache(2, 32, dtype=torch.float32, device="cpu")
    vec = model.init_cache(2, 32, dtype=torch.float32, device="cpu")
    lp, cache = model.prefill(params, {"tokens": tokens[:, :plen]}, cache)
    model.prefill(params, {"tokens": tokens[:, :plen]}, vec)
    np.testing.assert_allclose(lp[:, 0].numpy(), full[:, plen - 1].numpy(),
                               rtol=TOL_PREFILL, atol=TOL_PREFILL)
    for i in range(plen, tot):
        ld, cache = model.decode_step(params, cache, tokens[:, i:i + 1], i)
        lv, vec = model.decode_step(params, vec, tokens[:, i:i + 1], torch.tensor([i, i]))
        np.testing.assert_allclose(ld[:, 0].numpy(), full[:, i].numpy(),
                                   rtol=TOL_DECODE, atol=TOL_DECODE)
        np.testing.assert_allclose(lv.numpy(), ld.numpy(), rtol=1e-5, atol=1e-5)


def test_unported_families_and_devices_raise():
    item = "ROADMAP queue 1 item 13: the hybrid's mamba2"
    with pytest.raises(NotImplementedError, match=item):
        get_config("zamba2-2.7b")
    cfg = get_config("llama3.2-1b", smoke=True)
    with pytest.raises(NotImplementedError, match=item):
        Model(cfg.replace(family="hybrid"))
    with pytest.raises(ValueError, match="not a language model"):
        Model(get_config("sobel-hd"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Model(cfg).init(0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Model(cfg).init_cache(1, 4)


def test_init_is_deterministic_and_shaped():
    cfg = get_config("llama3.2-1b", smoke=True)
    model = Model(cfg)
    a, b = model.init(0, device="cpu"), model.init(0, device="cpu")
    ref_shapes = jax.tree.map(lambda s: s.shape,
                              RefModel(ref_get_config("llama3.2-1b", smoke=True)).abstract_params())
    assert jax.tree.map(lambda t: tuple(t.shape), a) == ref_shapes
    assert all(torch.equal(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


# ---------------------------------------------------------------------------
# The ssm family: falcon-mamba-7b
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def carried_ssm():
    rcfg = ref_get_config(SSM, smoke=True).replace(dtype="float32")
    cfg = get_config(SSM, smoke=True).replace(dtype="float32")
    rmodel = RefModel(rcfg)
    rparams = rmodel.init(jax.random.key(1))
    params = carry_params(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    return cfg, Model(cfg), params, rcfg, rmodel, rparams


def test_ssm_full_param_count():
    cfg = get_config(SSM)
    assert (cfg.num_layers, cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_dt_rank) == (
        64, 4096, 8192, 16, 256)
    assert Model(cfg).param_count() == 7_272_665_088 == RefModel(ref_get_config(SSM)).param_count()


def test_ssm_carry_and_forward_match_reference(carried_ssm):
    cfg, model, params, _rcfg, rmodel, rparams = carried_ssm
    assert params["layers"]["mamba"]["in_proj"].shape == (cfg.num_layers, cfg.d_model,
                                                          2 * cfg.d_inner)
    tokens = _tokens(cfg, (2, 12))
    want, _ = rmodel.forward(rparams, {"tokens": jnp.asarray(tokens)})
    got, aux = model.forward(params, {"tokens": torch.from_numpy(tokens)})
    assert aux == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_FORWARD, atol=TOL_FORWARD)


@pytest.mark.parametrize("plen", [3, 8])
def test_ssm_prefill_and_decode_match_reference(carried_ssm, plen):
    cfg, model, params, _rcfg, rmodel, rparams = carried_ssm
    tot = 12
    tokens = _tokens(cfg, (2, tot), seed=3)
    rcache = rmodel.init_cache(2, 32, dtype=jnp.float32)
    cache = model.init_cache(2, 32, dtype=torch.float32, device="cpu")
    rl, rcache = rmodel.prefill(rparams, {"tokens": jnp.asarray(tokens[:, :plen])}, rcache)
    lp, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens[:, :plen])}, cache)
    np.testing.assert_allclose(lp.numpy(), np.asarray(rl), rtol=TOL_PREFILL, atol=TOL_PREFILL)
    for i in range(plen, tot):
        step = tokens[:, i:i + 1]
        rd, rcache = rmodel.decode_step(rparams, rcache, jnp.asarray(step), jnp.int32(i))
        ld, cache = model.decode_step(params, cache, torch.from_numpy(step), i)
        np.testing.assert_allclose(ld.numpy(), np.asarray(rd), rtol=TOL_DECODE, atol=TOL_DECODE)
    for n in ("h", "conv"):
        np.testing.assert_allclose(cache["layers"][n].numpy(), np.asarray(rcache["layers"][n]),
                                   rtol=TOL_DECODE, atol=TOL_DECODE)


def test_ssm_prefill_decode_matches_own_forward(carried_ssm):
    """The ssm serving path reproduces the full forward; the decode step
    ignores its index (an ssm model keeps no positions)."""
    cfg, model, params = carried_ssm[:3]
    tot, plen = 12, 8
    tokens = torch.from_numpy(_tokens(cfg, (2, tot), seed=4))
    full, _ = model.forward(params, {"tokens": tokens})
    cache = model.init_cache(2, 32, dtype=torch.float32, device="cpu")
    other = model.init_cache(2, 32, dtype=torch.float32, device="cpu")
    lp, cache = model.prefill(params, {"tokens": tokens[:, :plen]}, cache)
    model.prefill(params, {"tokens": tokens[:, :plen]}, other)
    np.testing.assert_allclose(lp[:, 0].numpy(), full[:, plen - 1].numpy(),
                               rtol=TOL_PREFILL, atol=TOL_PREFILL)
    for i in range(plen, tot):
        ld, cache = model.decode_step(params, cache, tokens[:, i:i + 1], i)
        lo, other = model.decode_step(params, other, tokens[:, i:i + 1], torch.tensor([0, 99]))
        np.testing.assert_allclose(ld[:, 0].numpy(), full[:, i].numpy(),
                                   rtol=TOL_DECODE, atol=TOL_DECODE)
        assert torch.equal(lo, ld)
