"""The port's models against ``repro.models.Model`` with the same weights
(carried by ``carry_params``) at the smoke configs of every LM arch: the
dense archs (minicpm3-4b with MLA among them), both MoE archs,
falcon-mamba-7b (ssm), zamba2-2.7b (hybrid), whisper-large-v3 (encdec,
also with fewer encoder frames than ``encoder_len``) and pixtral-12b (vlm,
with its patches): forward logits (and a moe model's auxiliary losses), and
prefill + token-by-token decode logits, at the reference's own tolerances
(``tests/test_decode_consistency.py``: 3e-4 for prefill, 5e-4 for decode)
or tighter; the configs, the parameter counts (FULL ones too) and
``data.synthetic.lm_batch`` equal the reference's."""
import dataclasses
from unittest import mock

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
NEW = ("zamba2-2.7b", "whisper-large-v3", "pixtral-12b")   # hybrid, encdec, vlm
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


@pytest.mark.parametrize("arch", DENSE + (SSM,) + MOE_MLA + NEW)
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
    """Every LM family is ported: each of the reference's LM archs builds a
    ``Model``; an image config is refused, and so is a model on a host
    without CUDA unless the caller names the CPU."""
    from repro.configs import list_archs as ref_list_archs

    lm_archs = [a for a in ref_list_archs() if a != "sobel-hd"]
    assert sorted(lm_archs) == sorted(a for a in list_archs() if a != "sobel-hd")
    assert {get_config(a).family for a in lm_archs} == {"dense", "moe", "ssm", "hybrid",
                                                        "encdec", "vlm"}
    for arch in lm_archs:
        Model(get_config(arch))
    cfg = get_config("llama3.2-1b", smoke=True)
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


# ---------------------------------------------------------------------------
# The hybrid, encdec and vlm families: zamba2-2.7b, whisper-large-v3, pixtral-12b
# ---------------------------------------------------------------------------

FULL_COUNTS = {"zamba2-2.7b": 2_422_670_240, "whisper-large-v3": 1_601_198_080,
               "pixtral-12b": 12_247_782_400}


@pytest.mark.parametrize("arch", NEW)
def test_full_param_counts_of_the_three_families(arch):
    """FULL width and depth, as the reference counts them: each fits one
    80 GB card whole in f32 (9.7, 6.4 and 49.0 GB)."""
    assert Model(get_config(arch)).param_count() == FULL_COUNTS[arch] == RefModel(
        ref_get_config(arch)).param_count()


def _carried(arch):
    """The port's weights from seed 1, the same in every process, carried
    into the reference and back through ``carry_params``. The reference's
    initializer salts each leaf with the process's ``hash``, so its draws
    change from run to run; whisper's random-weight attention is sharp
    enough that some draws carry f32 rounding past the end-to-end
    tolerances (``test_whisper_blocks_match_reference_on_random_frames``)."""
    rcfg = ref_get_config(arch, smoke=True).replace(dtype="float32")
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    rmodel = RefModel(rcfg)
    rparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), Model(cfg).init(1, device="cpu"))
    params = carry_params(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    return cfg, Model(cfg), params, rcfg, rmodel, rparams


@pytest.fixture(scope="module", params=NEW)
def carried_new(request):
    return _carried(request.param)


def _frontend(cfg, b, seed=5, frames=None):
    """The stub frontends' inputs, numpy, as the reference's own
    ``tests/test_decode_consistency.py`` makes them: an encdec model's
    ``enc_embeds`` all 0.1 (``frames`` of them, default ``encoder_len``), a
    VLM's ``patch_embeds`` N(0, 1) x 0.1."""
    if cfg.family == "encdec":
        t = cfg.encoder_len if frames is None else frames
        return {"enc_embeds": np.full((b, t, cfg.d_model), 0.1, np.float32)}
    if cfg.family == "vlm":
        rng = np.random.default_rng(seed)
        return {"patch_embeds": (rng.standard_normal((b, cfg.num_patches, cfg.d_model))
                                 * 0.1).astype(np.float32)}
    return {}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_new_families_carry_their_subtrees(carried_new):
    """The hybrid's ``shared`` block, the encoder stack and the decoder's
    ``ln_x``/``cross`` cross over name for name and value for value."""
    cfg, _model, params, _rcfg, _rmodel, rparams = carried_new
    ref = jax.tree_util.tree_flatten_with_path(rparams)[0]
    for path, leaf in ref:
        node = params
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    want = {"zamba2-2.7b": {"shared"}, "whisper-large-v3": {"encoder"}, "pixtral-12b": set()}
    assert set(params) - {"embed", "layers", "final_norm"} == want[cfg.name.replace("-smoke", "")]
    if cfg.family == "encdec":
        assert {"ln_x", "cross"} <= set(params["layers"])
        assert params["encoder"]["layers"]["attn"]["wq"].shape[0] == cfg.encoder_layers
    if cfg.family == "hybrid":
        assert params["layers"]["mamba"]["a_log"].shape == (cfg.num_layers, cfg.ssm_heads)


def test_new_families_forward_matches_reference(carried_new):
    cfg, model, params, _rcfg, rmodel, rparams = carried_new
    tokens = _tokens(cfg, (2, 12))
    extra = _frontend(cfg, 2)
    want, want_aux = rmodel.forward(rparams, _jnp({"tokens": tokens, **extra}))
    got, aux = model.forward(params, _torch({"tokens": tokens, **extra}))
    assert got.shape == want.shape == (2, 12 + cfg.num_patches, cfg.vocab_size)
    assert aux == {} and dict(want_aux) == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_FORWARD, atol=TOL_FORWARD)


def _prefill_decode(cfg, model, params, rmodel, rparams, extra, tot=12, plen=8):
    """Prefill ``plen`` tokens and decode the rest on both packages, each
    step at the reference's tolerance; returns both caches."""
    tokens = _tokens(cfg, (2, tot), seed=3)
    off = cfg.num_patches if cfg.family == "vlm" else 0
    rcache = rmodel.init_cache(2, 32, dtype=jnp.float32)
    cache = model.init_cache(2, 32, dtype=torch.float32, device="cpu")
    rl, rcache = rmodel.prefill(rparams, _jnp({"tokens": tokens[:, :plen], **extra}), rcache)
    lp, cache = model.prefill(params, _torch({"tokens": tokens[:, :plen], **extra}), cache)
    np.testing.assert_allclose(lp.numpy(), np.asarray(rl), rtol=TOL_PREFILL, atol=TOL_PREFILL)
    for i in range(plen, tot):
        step = tokens[:, i:i + 1]
        rd, rcache = rmodel.decode_step(rparams, rcache, jnp.asarray(step), jnp.int32(off + i))
        ld, cache = model.decode_step(params, cache, torch.from_numpy(step), off + i)
        np.testing.assert_allclose(ld.numpy(), np.asarray(rd), rtol=TOL_DECODE, atol=TOL_DECODE)
    return cache, rcache


def _assert_caches_equal(cache, rcache):
    assert set(cache) == set(rcache)
    for key, sub in cache.items():
        pairs = sub.items() if isinstance(sub, dict) else [(None, sub)]
        for n, t in pairs:
            want = np.asarray(rcache[key] if n is None else rcache[key][n])
            assert tuple(t.shape) == want.shape, (key, n)
            np.testing.assert_allclose(t.numpy(), want, rtol=TOL_DECODE, atol=TOL_DECODE,
                                       err_msg=f"{key}/{n}")


def test_new_families_prefill_and_decode_match_reference(carried_new):
    cfg, model, params, _rcfg, rmodel, rparams = carried_new
    cache, rcache = _prefill_decode(cfg, model, params, rmodel, rparams, _frontend(cfg, 2))
    _assert_caches_equal(cache, rcache)


def test_whisper_with_fewer_frames_than_encoder_len():
    """``lm_batch``'s ``t_enc = min(encoder_len, seq_len)``: the prefill
    replaces the cache's cross k/v with the encoder's t_enc frames, as the
    reference's does, so the decode step attends to no zero keys."""
    cfg, model, params, _rcfg, rmodel, rparams = _carried("whisper-large-v3")
    t_enc = cfg.encoder_len - 7
    cache, rcache = _prefill_decode(cfg, model, params, rmodel, rparams,
                                    _frontend(cfg, 2, frames=t_enc))
    assert cache["cross_k"].shape == (cfg.num_layers, 2, t_enc, cfg.num_heads, cfg.head_dim)
    _assert_caches_equal(cache, rcache)


def test_whisper_blocks_match_reference_on_random_frames():
    """Random frames, N(0, 0.25): on them whisper's random-weight attention
    is sharp, and a last-bit difference grows from layer to layer (the
    reference parts from itself when the frames move by one ulp), so the
    port is held block by block: each encoder and decoder block (self-,
    cross-attention, MLP), run from the reference's hidden state, and the
    final norm and head on the reference's last hidden state, against the
    reference's: a block's output within the forward tolerance of its
    largest value (its residual sums cancel, so an element's own scale says
    nothing of the rounding it carries), the logits within it elementwise."""
    from repro.models import attention as RA
    from repro.models import transformer as RT
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T

    cfg, _model, params, rcfg, _rmodel, rparams = _carried("whisper-large-v3")
    rng = np.random.default_rng(6)
    enc = (rng.standard_normal((2, cfg.encoder_len, cfg.d_model)) * 0.5).astype(np.float32)
    tokens = _tokens(cfg, (2, 12), seed=7)

    def close(got, want, what):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= TOL_FORWARD, f"{what}: {err:.3g} of the largest value"

    t = cfg.encoder_len
    pos = np.broadcast_to(np.arange(t, dtype=np.int32)[None], (2, t)).copy()
    x = np.asarray(jnp.asarray(enc) + RT._sinusoid(jnp.asarray(pos), cfg.d_model))
    for i in range(cfg.encoder_layers):
        rlp = jax.tree.map(lambda a, i=i: a[i], rparams["encoder"]["layers"])
        want, _, _ = RT._apply_attn_block(rlp, rcfg, jnp.asarray(x), jnp.asarray(pos),
                                          causal=False)
        got, _, _ = T._apply_attn_block(T._layer(params["encoder"]["layers"], i), cfg,
                                        torch.from_numpy(x), torch.from_numpy(pos),
                                        causal=False)
        close(got, want, f"encoder block {i}")
        x = np.asarray(want)
    enc_out = np.asarray(RT.apply_norm(rparams["encoder"]["final_norm"], rcfg, jnp.asarray(x)))
    rx, rpos = RT._prepare_inputs(rparams, rcfg, {"tokens": jnp.asarray(tokens)}, jnp.float32)
    x, pos = np.asarray(rx), np.asarray(rpos)
    for i in range(cfg.num_layers):
        rlp = jax.tree.map(lambda a, i=i: a[i], rparams["layers"])
        lp = T._layer(params["layers"], i)
        rkv = RA.cross_kv(rlp["cross"], rcfg, jnp.asarray(enc_out))
        kv = A.cross_kv(lp["cross"], cfg, torch.from_numpy(enc_out))
        want, _, _ = RT._apply_attn_block(rlp, rcfg, jnp.asarray(x), jnp.asarray(pos),
                                          causal=True, enc_kv=rkv)
        got, _, _ = T._apply_attn_block(lp, cfg, torch.from_numpy(x), torch.from_numpy(pos),
                                        causal=True, enc_kv=kv)
        close(got, want, f"decoder block {i}")
        x = np.asarray(want)
    want = RT.unembed(rparams, rcfg, RT.apply_norm(rparams["final_norm"], rcfg, jnp.asarray(x)))
    got = T.unembed(params, cfg, T.apply_norm(params["final_norm"], cfg, torch.from_numpy(x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_FORWARD, atol=TOL_FORWARD)


def test_new_families_prefill_decode_matches_own_forward(carried_new):
    """The serving path reproduces the port's own forward (a VLM's logits
    offset by its patches), with per-slot decode indices equal to scalar
    ones."""
    cfg, model, params = carried_new[:3]
    tot, plen = 12, 8
    tokens = torch.from_numpy(_tokens(cfg, (2, tot), seed=4))
    extra = _torch(_frontend(cfg, 2))
    full, _ = model.forward(params, {"tokens": tokens, **extra})
    off = full.shape[1] - tot
    cache = model.init_cache(2, 32, dtype=torch.float32, device="cpu")
    vec = model.init_cache(2, 32, dtype=torch.float32, device="cpu")
    lp, cache = model.prefill(params, {"tokens": tokens[:, :plen], **extra}, cache)
    model.prefill(params, {"tokens": tokens[:, :plen], **extra}, vec)
    np.testing.assert_allclose(lp[:, 0].numpy(), full[:, off + plen - 1].numpy(),
                               rtol=TOL_PREFILL, atol=TOL_PREFILL)
    for i in range(plen, tot):
        ld, cache = model.decode_step(params, cache, tokens[:, i:i + 1], off + i)
        lv, vec = model.decode_step(params, vec, tokens[:, i:i + 1],
                                    torch.tensor([off + i, off + i]))
        np.testing.assert_allclose(ld[:, 0].numpy(), full[:, off + i].numpy(),
                                   rtol=TOL_DECODE, atol=TOL_DECODE)
        np.testing.assert_allclose(lv.numpy(), ld.numpy(), rtol=1e-5, atol=1e-5)


def test_hybrid_cache_layout_matches_reference():
    """zamba2's cache: the Mamba-2 state and conv tail per layer beside the
    shared block's k/v per group (FULL: 54 layers, 9 groups)."""
    for smoke in (True, False):
        cfg, rcfg = get_config("zamba2-2.7b", smoke=smoke), ref_get_config("zamba2-2.7b",
                                                                             smoke=smoke)
        if not smoke:
            assert cfg.num_layers // cfg.attn_every == 9
            cfg, rcfg = cfg.replace(num_layers=12), rcfg.replace(num_layers=12)
        cache = Model(cfg).init_cache(2, 5, dtype=torch.float32, device="cpu")
        rcache = RefModel(rcfg).init_cache(2, 5, dtype=jnp.float32)
        shapes = {k: {n: tuple(t.shape) for n, t in v.items()} for k, v in cache.items()}
        assert shapes == jax.tree.map(lambda a: tuple(a.shape), rcache)


@pytest.mark.parametrize("arch", ("llama3.2-1b", SSM, "qwen3-moe-30b-a3b") + NEW)
@pytest.mark.parametrize("seq_len", [12, 20])
def test_lm_batch_equals_reference(arch, seq_len):
    """``data.synthetic.lm_batch`` makes the reference's numpy arrays, with
    the stub frontends' inputs (whisper: min(encoder_len, seq_len) frames;
    pixtral: num_patches of the seq_len positions)."""
    from repro.data.synthetic import lm_batch as ref_lm_batch
    from repro_torch.data.synthetic import lm_batch

    cfg, rcfg = get_config(arch, smoke=True), ref_get_config(arch, smoke=True)
    got = lm_batch(cfg, 3, seq_len, seed=4, step=2)
    want = ref_lm_batch(rcfg, 3, seq_len, seed=4, step=2)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if cfg.family == "encdec":
        assert got["enc_embeds"].shape == (3, min(cfg.encoder_len, seq_len), cfg.d_model)
    if cfg.family == "vlm":
        with pytest.raises(ValueError, match="text tokens"):
            lm_batch(cfg, 1, cfg.num_patches + 1)


# ---------------------------------------------------------------------------
# The training half: cross_entropy, cast_params, loss_fn
# ---------------------------------------------------------------------------

LOSS_ARCHS = ("llama3.2-1b", "qwen3-moe-30b-a3b", "minicpm3-4b", "falcon-mamba-7b",
              "zamba2-2.7b", "whisper-large-v3", "pixtral-12b")
# f32 loss_fn: the loss within 1e-5 (observed <= 2.4e-6, whisper), each
# leaf's gradient within 1e-3 of the leaf's largest (observed <= 1.9e-4,
# whisper's cross-attention: random weights make its attention sharp).
TOL_LOSS, TOL_GRAD = 1e-5, 1e-3
# bf16 (cast_params): the two libraries round the bf16 casts and products
# at other places. The loss within 2e-2 (an ulp of bf16 at 6 is 3.1e-2;
# observed <= 7.3e-3); the whole gradient tree's difference from the
# reference's within 1.5x the reference's own bf16-against-f32 difference
# (observed 0.19-0.94 of it; whisper's encoder gradients are rounding
# through and through in both), and nearer to the reference's bf16 tree
# than to its f32 one (observed 0.08-0.94 of that distance; an f32
# forward would sit nearer the f32 tree).
TOL_LOSS_BF16, CONTROL_FACTOR = 2e-2, 1.5


def test_cross_entropy_matches_reference():
    from repro.models.model import cross_entropy as ref_xent
    from repro_torch.models import cross_entropy

    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((3, 5, 11)) * 4).astype(np.float32)
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    weights = (rng.random((3, 5)) < 0.6).astype(np.float32)
    for w in (None, weights, np.zeros_like(weights)):
        want = float(ref_xent(jnp.asarray(logits), jnp.asarray(labels),
                              None if w is None else jnp.asarray(w)))
        got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                            None if w is None else torch.from_numpy(w))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-6)
    bf16 = cross_entropy(torch.from_numpy(logits).to(torch.bfloat16), torch.from_numpy(labels),
                         None)
    assert bf16.dtype == torch.float32


def test_cast_params_casts_f32_leaves_only_and_keeps_the_graph():
    cfg = get_config("llama3.2-1b", smoke=True)          # dtype bfloat16
    params = Model(cfg).init(0, device="cpu")
    params["extra"] = torch.arange(3, dtype=torch.int32)
    leaf = params["layers"]["attn"]["wq"].requires_grad_(True)
    cast = Model(cfg).cast_params(params)
    assert cast["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert cast["extra"].dtype == torch.int32
    (cast["layers"]["attn"]["wq"].float().sum()).backward()
    assert leaf.grad is not None and leaf.grad.dtype == torch.float32
    f32 = Model(cfg.replace(dtype="float32")).cast_params(params)
    assert f32["layers"]["attn"]["wq"] is leaf


def _loss_and_grads(arch, dtype):
    """The port's and the reference's (loss, metrics, per-leaf gradients)
    from the port's seed-1 weights (f32 master weights, ``cast_params`` to
    ``dtype``) on ``lm_batch``'s batch of 2 x 16 text tokens, and the
    dtypes of the float weights that the port's forward was given."""
    from repro.data.synthetic import lm_batch
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves, leaves_with_path, unflatten

    rcfg = ref_get_config(arch, smoke=True).replace(dtype=dtype)
    cfg = get_config(arch, smoke=True).replace(dtype=dtype)
    params = Model(cfg).init(1, device="cpu")
    seq = 16 + (cfg.num_patches if cfg.family == "vlm" else 0)
    batch = lm_batch(rcfg, 2, seq, seed=0)
    rparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    (rloss, rmetrics), rgrads = jax.value_and_grad(RefModel(rcfg).loss_fn, has_aux=True)(
        rparams, _jnp(batch))
    paths = [p for p, _ in leaves_with_path(params)]
    flat = [t.clone().requires_grad_(True) for _, t in leaves_with_path(params)]
    with mock.patch.object(T, "forward", wraps=T.forward) as spy:
        loss, metrics = Model(cfg).loss_fn(unflatten(params, flat), _torch(batch))
    seen = {t.dtype for t in leaves(spy.call_args.args[0]) if t.is_floating_point()}
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    want = dict(leaves_with_path(jax.tree.map(np.asarray, rgrads)))
    return {"loss": (float(loss.detach()), float(rloss)),
            "metrics": ({k: float(v) for k, v in metrics.items()},
                        {k: float(v) for k, v in rmetrics.items()}),
            "grads": [(p, None if g is None else g.numpy(), want[p])
                      for p, g in zip(paths, grads)],
            "forward_dtypes": seen}


@pytest.fixture(scope="module", params=LOSS_ARCHS)
def losses(request):
    return {dt: _loss_and_grads(request.param, dt) for dt in ("float32", "bfloat16")}


def test_loss_fn_and_grads_match_reference_f32(losses):
    out = losses["float32"]
    got, want = out["loss"]
    assert got == pytest.approx(want, rel=TOL_LOSS, abs=TOL_LOSS)
    assert out["forward_dtypes"] == {torch.float32}
    metrics, rmetrics = out["metrics"]
    assert set(metrics) == set(rmetrics) and "xent" in metrics
    for k in metrics:
        assert metrics[k] == pytest.approx(rmetrics[k], rel=TOL_LOSS, abs=TOL_LOSS), k
    for path, g, w in out["grads"]:
        g = np.zeros_like(w) if g is None else g
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= TOL_GRAD * scale, path


def _tree_rel(a, b):
    num = sum(float(((x - y).astype(np.float64) ** 2).sum()) for x, y in zip(a, b))
    return (num / sum(float((y.astype(np.float64) ** 2).sum()) for y in b)) ** 0.5


def test_loss_fn_and_grads_match_reference_bf16_cast(losses):
    """``loss_fn`` runs the forward on ``cast_params``'s bf16 weights (the
    gradient bound alone would pass an f32 forward: the reference's own
    bf16-against-f32 difference is its scale), with the loss and the
    gradient tree near the reference's bf16 ones."""
    f32, bf16 = losses["float32"], losses["bfloat16"]
    assert bf16["forward_dtypes"] == {torch.bfloat16}
    got, want = bf16["loss"]
    assert abs(got - want) <= TOL_LOSS_BF16
    port = [np.zeros_like(w) if g is None else g for _p, g, w in bf16["grads"]]
    ref = [w for _p, _g, w in bf16["grads"]]
    ref32 = [w for _p, _g, w in f32["grads"]]
    control = _tree_rel(ref, ref32)
    assert _tree_rel(port, ref) <= CONTROL_FACTOR * control, (_tree_rel(port, ref), control)
    assert _tree_rel(port, ref) < _tree_rel(port, ref32), (_tree_rel(port, ref),
                                                           _tree_rel(port, ref32))
    assert all(np.isfinite(g).all() for g in port)
