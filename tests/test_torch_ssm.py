"""The port's Mamba-1 functions (``repro_torch.models.ssm``) against
``repro.models.ssm`` on the same weights, at the reference's own tolerance
(``tests/test_ssm.py``: 2e-4): the causal conv with and without a tail,
the chunk rule, the specs, the block's inputs, the prefill forward (the
port's scan is K5's plain version; the reference's a chunked associative
scan), its decode cache, and decode after prefill."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as RefConfig
from repro.models import ssm as rssm
from repro.models.layers import init_tree as ref_init_tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm
from repro_torch.models.layers import init_tree

TOL = 2e-4    # tests/test_ssm.py


def _cfgs(chunk=4, d_model=16, state=4, dt_rank=4):
    kw = dict(name="m1", family="ssm", num_layers=1, d_model=d_model, vocab_size=7,
              ssm_type="mamba1", ssm_state=state, ssm_chunk=chunk, ssm_dt_rank=dt_rank,
              attn_type="none", dtype="float32")
    return ModelConfig(**kw), RefConfig(**kw)


def _carry(rparams):
    return {k: torch.tensor(np.asarray(v)) for k, v in rparams.items()}


@pytest.fixture(scope="module")
def block():
    cfg, rcfg = _cfgs()
    rparams = ref_init_tree(rssm.mamba1_params(rcfg), jax.random.key(0))
    x = np.random.default_rng(1).normal(0, 1, (2, 12, cfg.d_model)).astype(np.float32)
    return cfg, rcfg, _carry(rparams), rparams, x


@pytest.mark.parametrize("with_tail", [False, True], ids=["padded", "tail"])
def test_causal_conv_matches_reference(with_tail):
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 6, 5)).astype(np.float32)
    w = rng.normal(0, 1, (5, 4)).astype(np.float32)
    b = rng.normal(0, 1, (5,)).astype(np.float32)
    tail = rng.normal(0, 1, (2, 3, 5)).astype(np.float32) if with_tail else None
    want, want_tail = rssm._causal_conv(*map(jnp.asarray, (x, w, b)),
                                        None if tail is None else jnp.asarray(tail))
    got, got_tail = ssm._causal_conv(*map(torch.from_numpy, (x, w, b)),
                                     None if tail is None else torch.from_numpy(tail))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got_tail.numpy(), np.asarray(want_tail))


@pytest.mark.parametrize("l", [1, 7, 12, 16, 64, 1000, 2048])
def test_pick_chunk_matches_reference(l):
    for target in (1, 4, 8, 16, 128):
        assert ssm._pick_chunk(l, target) == rssm._pick_chunk(l, target)
    assert ssm._pick_chunk(1000, 16) == 10


def test_specs_and_inits_match_reference():
    cfg, rcfg = _cfgs(d_model=32, state=16, dt_rank=0)
    assert cfg.ssm_dt_rank == rcfg.ssm_dt_rank == 2 and cfg.d_inner == rcfg.d_inner == 64
    specs, rspecs = ssm.mamba1_params(cfg), rssm.mamba1_params(rcfg)
    assert {k: tuple(s) for k, s in specs.items()} == {k: tuple(s) for k, s in rspecs.items()}
    ref = ref_init_tree(rspecs, jax.random.key(0))
    mine = init_tree(specs, 0)
    # Deterministic inits equal; the random dt bias lies in the same range.
    for name in ("a_log", "conv_b", "d_skip"):
        np.testing.assert_allclose(mine[name].numpy(), np.asarray(ref[name]), rtol=1e-6)
    for dt_b in (mine["dt_b"].numpy(), np.asarray(ref["dt_b"])):
        sp = np.log1p(np.exp(dt_b))
        assert sp.min() >= 1e-3 * (1 - 1e-5) and sp.max() <= 1e-1 * (1 + 1e-5)


def test_block_inputs_match_reference(block):
    cfg, rcfg, params, rparams, x = block
    got = ssm._mamba1_inputs(params, cfg, torch.from_numpy(x))
    want = rssm._mamba1_inputs(rparams, rcfg, jnp.asarray(x))
    for name, g, w in zip(("xc", "z", "dt", "a", "b", "c", "tail", "xin"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("chunk", [1, 4, 12])
def test_apply_mamba1_matches_reference(block, chunk):
    cfg, rcfg, params, rparams, x = block
    cfg, rcfg = cfg.replace(ssm_chunk=chunk), rcfg.replace(ssm_chunk=chunk)
    want = np.asarray(rssm.apply_mamba1(rparams, rcfg, jnp.asarray(x)))
    got = ssm.apply_mamba1(params, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_prefill_cache_and_decode_match_reference(block):
    cfg, rcfg, params, rparams, x = block
    rout, rcache = rssm.apply_mamba1(rparams, rcfg, jnp.asarray(x[:, :5]), return_cache=True)
    out, cache = ssm.apply_mamba1(params, cfg, torch.from_numpy(x[:, :5]), return_cache=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), rtol=TOL, atol=TOL)
    for name in ("h", "conv"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(rcache[name]), rtol=TOL,
                                   atol=TOL, err_msg=name)
    assert cache["h"].dtype == torch.float32
    for t in range(5, 12):
        ry, rcache = rssm.mamba1_decode(rparams, rcfg, jnp.asarray(x[:, t:t + 1]), rcache)
        y, new = ssm.mamba1_decode(params, cfg, torch.from_numpy(x[:, t:t + 1]), cache)
        assert new["h"] is not cache["h"]          # the old cache is left as it was
        cache = new
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=TOL, atol=TOL)
        for name in ("h", "conv"):
            np.testing.assert_allclose(cache[name].numpy(), np.asarray(rcache[name]),
                                       rtol=TOL, atol=TOL, err_msg=f"{name} at {t}")


def test_init_cache_and_refusals(block):
    cfg, rcfg = block[:2]
    cache = ssm.init_mamba1_cache(cfg, 3, torch.float32, device="cpu")
    rcache = rssm.init_mamba1_cache(rcfg, 3, jnp.float32)
    for name in ("h", "conv"):
        assert tuple(cache[name].shape) == rcache[name].shape and not cache[name].any()
    with pytest.raises(NotImplementedError, match="ssm_scan_dtype"):
        ssm.apply_mamba1(block[2], cfg.replace(ssm_scan_dtype="bfloat16"),
                         torch.from_numpy(block[4]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ssm.init_mamba1_cache(cfg, 1)
