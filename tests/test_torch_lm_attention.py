"""The port's attention against ``repro.models.attention`` on the same numpy
inputs and weights: ``update_cache`` in its three index forms,
``dot_attention`` dense and chunked (with and without a softcap), and
``apply_attention`` in prefill and decode, GQA and MLA (minicpm3-4b's
expanded prefill and absorbed decode), whisper's cross-attention
(``cross_kv``, ``apply_cross_attention``) and ``transformer._sinusoid``, on
the plain lane (CPU); and the card lane's routes through K4 (MLA's
zero-padded v, the cross-attention non-causal) run with K4's plain
version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as RA
from repro_torch.configs import get_config
from repro_torch.models import attention as A

TOL = 1e-5   # f32 on both sides, sums in another order


def _cfgs(arch="llama3.2-1b", **kw):
    return (get_config(arch, smoke=True).replace(dtype="float32", **kw),
            ref_get_config(arch, smoke=True).replace(dtype="float32", **kw))


def _params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(0, 1, s.shape) / np.sqrt(s.shape[0])).astype(np.float32)
            for k, s in A.attention_params(cfg).items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("index,s", [
    (np.int32(0), 1), (np.int32(3), 1), (np.int32(-3), 1), (np.int32(10), 1),
    (np.int32(0), 3), (np.int32(3), 3), (np.int32(-3), 3), (np.int32(9), 3), (np.int32(-20), 3),
    (np.array([2, 0, 9], np.int32), 1), (np.array([-1, 11, 4], np.int32), 1),
    (np.array([[0, 1, 2], [5, 9, 9], [3, 4, 40]], np.int32), 3),
], ids=["s0", "s3", "s-3-none", "s10-none", "blk0", "blk3", "blk-3", "blk9-clamped",
        "blk-20", "b", "b-neg-drop", "bs-trash-drop"])
def test_update_cache_matches_reference(index, s):
    rng = np.random.default_rng(4)
    cache = rng.normal(0, 1, (3, 10, 2, 4)).astype(np.float32)
    new = rng.normal(0, 1, (3, s, 2, 4)).astype(np.float32)
    want = np.asarray(RA.update_cache(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(index)))
    got = torch.from_numpy(cache.copy())
    out = A.update_cache(got, torch.from_numpy(new), torch.from_numpy(np.asarray(index)))
    assert out is got   # written in place
    if index.ndim == 2:
        # duplicate destinations (the trash slot 9) keep an unspecified one
        # of their values in either package: compare every other row
        keep = np.ones(10, bool)
        keep[9] = False
        np.testing.assert_array_equal(got.numpy()[:, keep], want[:, keep])
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("impl,t,chunk,softcap,causal", [
    ("dense", 12, 1024, 0.0, True),
    ("dense", 12, 1024, 5.0, True),
    ("dense", 12, 1024, 0.0, False),
    ("chunked", 32, 8, 0.0, True),
    ("chunked", 32, 8, 3.0, True),
    ("chunked", 32, 8, 0.0, False),
    ("chunked", 8, 8, 0.0, True),   # t <= chunk takes the dense path
])
def test_dot_attention_matches_reference(impl, t, chunk, softcap, causal):
    b, s, kv, g, d = 2, t, 2, 3, 8
    rng = np.random.default_rng(5)
    q = rng.normal(0, 1, (b, s, kv, g, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, t, kv, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, t, kv, d)).astype(np.float32)
    pos = np.stack([np.arange(t), np.arange(t) + 3]).astype(np.int32)
    kw = dict(causal=causal, impl=impl, chunk=chunk, softcap=softcap)
    want = np.asarray(RA.dot_attention(*map(jnp.asarray, (q, k, v)), pos_q=jnp.asarray(pos),
                                       pos_k=jnp.asarray(pos), **kw))
    got = A.dot_attention(*map(torch.from_numpy, (q, k, v)), pos_q=torch.from_numpy(pos),
                          pos_k=torch.from_numpy(pos), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmo-1b", "glm4-9b"])
@pytest.mark.parametrize("index_form", ["none", "scalar", "bs"])
def test_apply_attention_prefill_matches_reference(arch, index_form):
    cfg, rcfg = _cfgs(arch)
    params = _params(cfg)
    b, s, L = 2, 6, 9
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    cache = index = None
    if index_form != "none":
        cache = {n: rng.normal(0, 1, (b, L, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
                 for n in ("k", "v")}
        index = (np.int32(0) if index_form == "scalar"
                 else np.where(np.arange(s) < 4, np.arange(s), 8)[None].repeat(b, 0).astype(np.int32))
    want, want_cache = RA.apply_attention(
        _j(params), rcfg, jnp.asarray(x), jnp.asarray(pos),
        cache=None if cache is None else _j(cache),
        cache_index=None if index is None else jnp.asarray(index))
    got, got_cache = A.apply_attention(
        _t(params), cfg, torch.from_numpy(x), torch.from_numpy(pos),
        cache=None if cache is None else _t(cache),
        cache_index=None if index is None else torch.from_numpy(np.asarray(index)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    if cache is not None:
        rows = slice(0, 8)   # row 8 is the trash slot of the (B, S) form
        for n in ("k", "v"):
            np.testing.assert_allclose(got_cache[n].numpy()[:, rows],
                                       np.asarray(want_cache[n])[:, rows], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "glm4-9b"])
@pytest.mark.parametrize("index", [np.int32(5), np.array([5, 2, 7], np.int32)],
                         ids=["scalar", "per-slot"])
def test_apply_attention_decode_matches_reference(arch, index):
    cfg, rcfg = _cfgs(arch)
    params = _params(cfg, seed=1)
    b, L = 3, 9
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (b, 1, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.asarray(index, np.int32), (b,))[:, None].copy()
    cache = {n: rng.normal(0, 1, (b, L, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
             for n in ("k", "v")}
    want, want_cache = RA.apply_attention(_j(params), rcfg, jnp.asarray(x), jnp.asarray(pos),
                                          cache=_j(cache), cache_index=jnp.asarray(index))
    got, got_cache = A.apply_attention(_t(params), cfg, torch.from_numpy(x),
                                       torch.from_numpy(pos), cache=_t(cache),
                                       cache_index=torch.from_numpy(np.asarray(index)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(got_cache[n].numpy(), np.asarray(want_cache[n]),
                                   rtol=TOL, atol=TOL)


def test_params_and_cache_match_reference():
    for arch in ("llama3.2-1b", "olmo-1b", "glm4-9b"):
        cfg, rcfg = _cfgs(arch)
        assert {k: tuple(s) for k, s in A.attention_params(cfg).items()} == \
            {k: tuple(s) for k, s in RA.attention_params(rcfg).items()}
        cache = A.init_attn_cache(cfg, 2, 7, device="cpu")
        ref = RA.init_attn_cache(rcfg, 2, 7)
        for n in ("k", "v"):
            assert tuple(cache[n].shape) == ref[n].shape
            assert cache[n].dtype == torch.bfloat16 and not cache[n].any()
    cfg, _ = _cfgs(qk_norm=True)
    assert {"q_norm", "k_norm"} <= set(A.attention_params(cfg))


def test_mla_and_unported_parts_raise():
    """MLA is ported (its specs and caches build), and so are cross-attention
    and the encoder-decoder family (their specs are the reference's); what
    is not a language model still raises."""
    from repro.models import transformer as RT
    from repro_torch.models import transformer as T

    cfg, _ = _cfgs("minicpm3-4b")
    assert {"wkv_a", "kv_norm", "wk_b", "wv_b", "wo", "wq_a", "q_norm", "wq_b"} == set(
        A.attention_params(cfg))
    assert set(A.init_attn_cache(cfg, 1, 4, device="cpu")) == {"ckv", "k_rope"}
    wcfg, rwcfg = _cfgs("whisper-large-v3")
    assert {k: tuple(s) for k, s in A.cross_attention_params(wcfg).items()} == {
        k: tuple(s) for k, s in RA.cross_attention_params(rwcfg).items()}
    for family in T.LM_FAMILIES:
        T.check_family(get_config("llama3.2-1b", smoke=True).replace(family=family))
    assert set(T.LM_FAMILIES) == {"dense", "moe", "ssm", "hybrid", "encdec", "vlm"}
    enc = T._attn_layer_specs(wcfg, moe=False, cross=True)
    assert set(enc) == set(RT._attn_layer_specs(rwcfg, moe=False, cross=True)) == {
        "ln1", "attn", "ln2", "ffn", "ln_x", "cross"}
    with pytest.raises(ValueError, match="not a language model"):
        T.check_family(get_config("sobel-hd"))


# ---------------------------------------------------------------------------
# Cross-attention (whisper) and the sinusoid
# ---------------------------------------------------------------------------

def _cross_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(0, 1, s.shape) / np.sqrt(s.shape[0])).astype(np.float32)
            for k, s in A.cross_attention_params(cfg).items()}


@pytest.mark.parametrize("s,t", [(1, 16), (5, 16), (7, 3)], ids=["decode", "prefill", "t<s"])
def test_cross_kv_and_cross_attention_match_reference(s, t):
    cfg, rcfg = _cfgs("whisper-large-v3")
    params = _cross_params(cfg)
    rng = np.random.default_rng(11)
    enc = rng.normal(0, 1, (2, t, cfg.d_model)).astype(np.float32)
    x = rng.normal(0, 1, (2, s, cfg.d_model)).astype(np.float32)
    rk, rv = RA.cross_kv(_j(params), rcfg, jnp.asarray(enc))
    k, v = A.cross_kv(_t(params), cfg, torch.from_numpy(enc))
    assert tuple(k.shape) == rk.shape == (2, t, cfg.num_heads, cfg.head_dim)
    np.testing.assert_allclose(k.numpy(), np.asarray(rk), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=TOL, atol=TOL)
    want = RA.apply_cross_attention(_j(params), rcfg, jnp.asarray(x), rk, rv)
    got = A.apply_cross_attention(_t(params), cfg, torch.from_numpy(x), k, v)
    assert tuple(got.shape) == (2, s, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("d", [16, 64, 1280, 7])
def test_sinusoid_matches_reference(d):
    from repro.models import transformer as RT
    from repro_torch.models import transformer as T

    # positions up to whisper's 1,500 encoder frames
    pos = np.array([[0, 1, 5, 1499], [31, 32, 448, 1056]], np.int32)
    want = np.asarray(RT._sinusoid(jnp.asarray(pos), d))
    got = T._sinusoid(torch.from_numpy(pos), d)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, 4, 2 * (d // 2))
    # The libraries' f32 exp may part a frequency by one ulp (6e-8 of it),
    # which 1,499 positions turn into ~1e-4 of an angle.
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("s", [1, 5])
def test_cross_attention_card_lane_runs_k4_noncausal(monkeypatch, s):
    """On the card lane the prefill's cross-attention (S > 1) is one K4
    call, non-causal, over the encoder's T keys with KV = H; a single query
    row (the decode step) stays plain. K4 replaced by its plain version:
    the same output as the plain lane."""
    from repro_torch.kernels import flash_attention as FA

    cfg, _ = _cfgs("whisper-large-v3")
    params = _t(_cross_params(cfg))
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(0, 1, (2, s, cfg.d_model)).astype(np.float32))
    enc = torch.from_numpy(rng.normal(0, 1, (2, 11, cfg.d_model)).astype(np.float32))
    k, v = A.cross_kv(params, cfg, enc)
    calls = []

    def plain_k4(q, kk, vv, *, causal, block_q, block_kv):
        calls.append((tuple(q.shape), tuple(kk.shape), causal, block_q, block_kv))
        return FA.flash_attention(q, kk, vv, causal=causal, block_q=block_q,
                                  block_kv=block_kv, backend="torch")

    monkeypatch.setattr(A, "k4_attention", plain_k4)
    monkeypatch.setattr(A, "resolve_backend", lambda backend, device: "cuda")
    got = A.apply_cross_attention(params, cfg, x, k, v)
    h, d = cfg.num_heads, cfg.head_dim
    assert calls == ([((2, h, s, d), (2, h, 11, d), False, s, 11)] if s > 1 else [])
    monkeypatch.undo()
    want = A.apply_cross_attention(params, cfg, x, k, v, backend="torch")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# MLA (minicpm3-4b)
# ---------------------------------------------------------------------------

MLA_VARIANTS = {"q_lora": {}, "no_q_lora": {"q_lora_rank": 0}}


def _mla_cache(cfg, b, L, rng):
    return {"ckv": rng.normal(0, 1, (b, L, cfg.kv_lora_rank)).astype(np.float32),
            "k_rope": rng.normal(0, 1, (b, L, cfg.qk_rope_head_dim)).astype(np.float32)}


@pytest.mark.parametrize("variant", MLA_VARIANTS)
def test_mla_params_and_cache_match_reference(variant):
    cfg, rcfg = _cfgs("minicpm3-4b", **MLA_VARIANTS[variant])
    assert {k: tuple(s) for k, s in A.attention_params(cfg).items()} == \
        {k: tuple(s) for k, s in RA.attention_params(rcfg).items()}
    cache, ref = A.init_attn_cache(cfg, 2, 7, device="cpu"), RA.init_attn_cache(rcfg, 2, 7)
    assert set(cache) == set(ref) == {"ckv", "k_rope"}
    for n in cache:
        assert tuple(cache[n].shape) == ref[n].shape
        assert cache[n].dtype == torch.bfloat16 and not cache[n].any()


@pytest.mark.parametrize("variant", MLA_VARIANTS)
@pytest.mark.parametrize("index_form", ["none", "scalar", "bs"])
def test_apply_mla_prefill_matches_reference(variant, index_form):
    """The expanded form: per-head k and v from the latent, q and k of
    nope + rope dims, v of v_head_dim; the latent cache written through."""
    cfg, rcfg = _cfgs("minicpm3-4b", **MLA_VARIANTS[variant])
    params = _params(cfg, seed=2)
    b, s, L = 2, 6, 9
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    cache = index = None
    if index_form != "none":
        cache = _mla_cache(cfg, b, L, rng)
        trash = np.where(np.arange(s) < 4, np.arange(s), 8)[None].repeat(b, 0).astype(np.int32)
        index = np.int32(0) if index_form == "scalar" else trash
    want, want_cache = RA.apply_attention(
        _j(params), rcfg, jnp.asarray(x), jnp.asarray(pos),
        cache=None if cache is None else _j(cache),
        cache_index=None if index is None else jnp.asarray(index))
    got, got_cache = A.apply_attention(
        _t(params), cfg, torch.from_numpy(x), torch.from_numpy(pos),
        cache=None if cache is None else _t(cache),
        cache_index=None if index is None else torch.from_numpy(np.asarray(index)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    if cache is None:
        assert got_cache is None and want_cache is None
    else:
        rows = slice(0, 8)   # row 8 is the trash slot of the (B, S) form
        assert set(got_cache) == set(want_cache) == {"ckv", "k_rope"}
        for n in got_cache:
            np.testing.assert_allclose(got_cache[n].numpy()[:, rows],
                                       np.asarray(want_cache[n])[:, rows], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("variant", MLA_VARIANTS)
@pytest.mark.parametrize("index", [np.int32(5), np.array([5, 2, 7], np.int32)],
                         ids=["scalar", "per-slot"])
def test_apply_mla_decode_matches_reference(variant, index):
    """The absorbed decode: q_nope projected into the latent space, the
    cache never expanded, positions past each row's masked."""
    cfg, rcfg = _cfgs("minicpm3-4b", **MLA_VARIANTS[variant])
    params = _params(cfg, seed=3)
    b, L = 3, 9
    rng = np.random.default_rng(9)
    x = rng.normal(0, 1, (b, 1, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.asarray(index, np.int32), (b,))[:, None].copy()
    cache = _mla_cache(cfg, b, L, rng)
    want, want_cache = RA.apply_attention(_j(params), rcfg, jnp.asarray(x), jnp.asarray(pos),
                                          cache=_j(cache), cache_index=jnp.asarray(index))
    got, got_cache = A.apply_attention(_t(params), cfg, torch.from_numpy(x),
                                       torch.from_numpy(pos), cache=_t(cache),
                                       cache_index=torch.from_numpy(np.asarray(index)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    for n in ("ckv", "k_rope"):
        np.testing.assert_allclose(got_cache[n].numpy(), np.asarray(want_cache[n]),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("s", [1, 6, 33])
@pytest.mark.parametrize("causal", [True, False])
def test_mla_zero_padded_v_route_equals_unpadded_attention(monkeypatch, s, causal):
    """The card lane's MLA route, v zero-padded to k's width for K4 and the
    output sliced back, run with K4 replaced by its plain version: equal to
    ``dot_attention`` on the unpadded v (the reference's MLA prefill), and
    the padded columns of K4's output exactly 0."""
    from repro_torch.kernels import flash_attention as FA

    cfg, _ = _cfgs("minicpm3-4b")
    b, h = 2, cfg.num_heads
    d, dv = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim
    rng = np.random.default_rng(10)
    q5 = torch.from_numpy(rng.normal(0, 1, (b, s, h, 1, d)).astype(np.float32))
    k = torch.from_numpy(rng.normal(0, 1, (b, s, h, d)).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 1, (b, s, h, dv)).astype(np.float32))
    outs = []

    def plain_k4(q, kk, vv, *, causal, block_q, block_kv):
        assert vv.shape == kk.shape
        out = FA.flash_attention(q, kk, vv, causal=causal, block_q=block_q,
                                 block_kv=block_kv, backend="torch")
        outs.append(out)
        return out

    monkeypatch.setattr(A, "k4_attention", plain_k4)
    got = A._k4_attention_narrow_v(q5, k, v, causal)
    pos = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    want = A.dot_attention(q5, k, v, pos_q=pos, pos_k=pos, causal=causal)
    assert got.shape == want.shape == (b, s, h, 1, dv)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    assert len(outs) == 1 and outs[0].shape[-1] == d
    assert torch.count_nonzero(outs[0][..., dv:]) == 0


def test_card_lane_refuses_what_k4_cannot_take():
    """On the card the causal prefill runs K4, which masks by index and has
    no softcap: other positions or a softcap raise instead of falling back."""
    cfg, _ = _cfgs()
    arange = torch.arange(6, dtype=torch.int32).expand(2, 6)
    A._check_k4_call(cfg, arange, causal=True)
    with pytest.raises(ValueError, match="arange"):
        A._check_k4_call(cfg, arange + 1, causal=True)
    A._check_k4_call(cfg, arange + 1, causal=False)   # no mask, positions only rotate
    with pytest.raises(ValueError, match="softcap"):
        A._check_k4_call(cfg.replace(attn_logit_softcap=30.0), arange, causal=True)
    x = torch.zeros(2, 6, cfg.d_model)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        A.apply_attention(_t(_params(cfg)), cfg, x, arange, backend="cuda")
