"""The port's attention against ``repro.models.attention`` on the same numpy
inputs and weights: ``update_cache`` in its three index forms,
``dot_attention`` dense and chunked (with and without a softcap), and
``apply_attention`` in prefill and decode, on the plain lane (CPU)."""
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
    cfg, _ = _cfgs(attn_type="mla")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        A.attention_params(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        A.init_attn_cache(cfg, 1, 4, device="cpu")


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
