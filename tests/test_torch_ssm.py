"""The port's Mamba-1 and Mamba-2 functions (``repro_torch.models.ssm``)
against ``repro.models.ssm`` on the same weights, at the reference's own
tolerance (``tests/test_ssm.py``: 2e-4): the causal conv with and without a
tail, the chunk rule, the specs and inits, the block's inputs, the prefill
forward (Mamba-1: the port's scan is K5's plain version, the reference's a
chunked associative scan; Mamba-2: the SSD at one chunk and at several),
its decode cache, and decode after prefill."""
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
    with pytest.raises(NotImplementedError, match="ssm_scan_dtype='float16'"):
        ssm.apply_mamba1(block[2], cfg.replace(ssm_scan_dtype="float16"),
                         torch.from_numpy(block[4]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ssm.init_mamba1_cache(cfg, 1)


# ---------------------------------------------------------------------------
# Mamba-2 (SSD): zamba2's backbone
# ---------------------------------------------------------------------------

def _cfgs2(chunk=4, d_model=16, state=4, head_dim=8):
    kw = dict(name="m2", family="hybrid", num_layers=1, d_model=d_model, vocab_size=7,
              num_heads=2, num_kv_heads=2, ssm_type="mamba2", ssm_state=state,
              ssm_head_dim=head_dim, ssm_chunk=chunk, attn_every=1, dtype="float32")
    return ModelConfig(**kw), RefConfig(**kw)


@pytest.fixture(scope="module")
def block2():
    cfg, rcfg = _cfgs2()
    rparams = ref_init_tree(rssm.mamba2_params(rcfg), jax.random.key(0))
    # The conv's N(0, 0.02) init leaves the SSD's inputs near 0; taps of
    # N(0, 0.5) give states of order 1, so the comparison weighs them.
    rparams = dict(rparams, conv_w=rparams["conv_w"] * 25.0)
    x = np.random.default_rng(1).normal(0, 1, (2, 12, cfg.d_model)).astype(np.float32)
    return cfg, rcfg, _carry(rparams), rparams, x


def test_mamba2_specs_and_inits_match_reference():
    cfg, rcfg = _cfgs2(d_model=32, state=16, head_dim=16)
    assert cfg.ssm_heads == rcfg.ssm_heads == 4 and cfg.d_inner == rcfg.d_inner == 64
    specs, rspecs = ssm.mamba2_params(cfg), rssm.mamba2_params(rcfg)
    assert {k: tuple(s) for k, s in specs.items()} == {k: tuple(s) for k, s in rspecs.items()}
    ref = ref_init_tree(rspecs, jax.random.key(0))
    mine, again = init_tree(specs, 0), init_tree(specs, 0)
    assert all(torch.equal(mine[k], again[k]) for k in mine)
    for name in ("conv_b", "d_skip", "norm"):
        np.testing.assert_array_equal(mine[name].numpy(), np.asarray(ref[name]))
    # A = -exp(a_log) in [-16, -1] in both initializers (the draws differ)
    for a_log in (mine["a_log"].numpy(), np.asarray(ref["a_log"])):
        assert a_log.min() >= 0.0 and a_log.max() <= np.log(16.0) + 1e-6
    assert len(np.unique(mine["a_log"].numpy())) == cfg.ssm_heads


def test_mamba2_inputs_match_reference(block2):
    cfg, rcfg, params, rparams, x = block2
    got = ssm._mamba2_inputs(params, cfg, torch.from_numpy(x))
    want = rssm._mamba2_inputs(rparams, rcfg, jnp.asarray(x))
    for name, g, w in zip(("x", "z", "dt", "a", "b", "c", "tail", "xbc"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("chunk", [12, 4, 3], ids=["1-chunk", "3-chunks", "4-chunks"])
def test_apply_mamba2_matches_reference(block2, chunk):
    cfg, rcfg, params, rparams, x = block2
    cfg, rcfg = cfg.replace(ssm_chunk=chunk), rcfg.replace(ssm_chunk=chunk)
    want = np.asarray(rssm.apply_mamba2(rparams, rcfg, jnp.asarray(x)))
    got = ssm.apply_mamba2(params, cfg, torch.from_numpy(x))
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("plen,chunk", [(8, 4), (5, 5), (8, 8)], ids=["2-chunks", "5", "8"])
def test_mamba2_prefill_cache_and_decode_match_reference(block2, plen, chunk):
    cfg, rcfg, params, rparams, x = block2
    cfg, rcfg = cfg.replace(ssm_chunk=chunk), rcfg.replace(ssm_chunk=chunk)
    rout, rcache = rssm.apply_mamba2(rparams, rcfg, jnp.asarray(x[:, :plen]), return_cache=True)
    out, cache = ssm.apply_mamba2(params, cfg, torch.from_numpy(x[:, :plen]), return_cache=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), rtol=TOL, atol=TOL)
    # The state is a sum of dt * x * B with dt in [1e-3, 1e-1]: of order
    # 1e-2, so it is held to an absolute tolerance 100x tighter.
    atol = {"h": TOL / 100, "conv": TOL}
    for name in ("h", "conv"):
        assert tuple(cache[name].shape) == rcache[name].shape
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(rcache[name]), rtol=TOL,
                                   atol=atol[name], err_msg=name)
    assert cache["h"].dtype == torch.float32 and float(cache["h"].abs().max()) > 0.01
    for t in range(plen, 12):
        ry, rcache = rssm.mamba2_decode(rparams, rcfg, jnp.asarray(x[:, t:t + 1]), rcache)
        y, new = ssm.mamba2_decode(params, cfg, torch.from_numpy(x[:, t:t + 1]), cache)
        assert new["h"] is not cache["h"]          # the old cache is left as it was
        cache = new
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=TOL, atol=TOL)
        for name in ("h", "conv"):
            np.testing.assert_allclose(cache[name].numpy(), np.asarray(rcache[name]),
                                       rtol=TOL, atol=atol[name], err_msg=f"{name} at {t}")


def test_mamba2_decode_after_prefill_equals_the_longer_forward(block2):
    """Prefill 7 tokens, decode the rest one by one: the same outputs as
    the SSD forward over all 12 (state carried across chunk borders)."""
    cfg, _rcfg, params, _rparams, x = block2
    full = ssm.apply_mamba2(params, cfg, torch.from_numpy(x))
    _, cache = ssm.apply_mamba2(params, cfg, torch.from_numpy(x[:, :7]), return_cache=True)
    for t in range(7, 12):
        y, cache = ssm.mamba2_decode(params, cfg, torch.from_numpy(x[:, t:t + 1]), cache)
        np.testing.assert_allclose(y[:, 0].numpy(), full[:, t].numpy(), rtol=TOL, atol=TOL)


def test_init_mamba2_cache(block2):
    cfg, rcfg = block2[:2]
    cache = ssm.init_mamba2_cache(cfg, 3, torch.float32, device="cpu")
    rcache = rssm.init_mamba2_cache(rcfg, 3, jnp.float32)
    for name in ("h", "conv"):
        assert tuple(cache[name].shape) == rcache[name].shape and not cache[name].any()
    assert ssm.init_mamba2_cache(cfg, 1, torch.bfloat16, device="cpu")["h"].dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ssm.init_mamba2_cache(cfg, 1)


# ---------------------------------------------------------------------------
# bf16 scan elements (ssm_scan_dtype="bfloat16")
# ---------------------------------------------------------------------------

# The reference composes a chunk with an associative scan (a tree of bf16
# products), the port step by step: the two round at other places and
# cannot be bit-equal. The bound is the reference's own distance from its
# f32 scan on the same inputs (L2 over the whole output), twice over:
# observed 0.32-1.53 of it on these weights at L = 32, chunks 4-16, 12
# input seeds. The weights are the port's draw (the reference's
# initializer salts its draws with the process's hash), the conv taps x5
# so that the scan's inputs, not f32 noise, set the distances.
BF16_CONTROL_FACTOR = 2.0


def _l2(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64)))


@pytest.fixture(scope="module")
def block_bf16():
    cfg, rcfg = _cfgs(d_model=16, state=4)
    params = init_tree(ssm.mamba1_params(cfg), 0, device="cpu")
    params["conv_w"] = params["conv_w"] * 5
    rparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    x = np.random.default_rng(0).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    return cfg, rcfg, params, rparams, x


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_bf16_scan_prefill_and_state_match_reference(block_bf16, chunk):
    cfg, rcfg, params, rparams, x = block_bf16
    c16 = cfg.replace(ssm_chunk=chunk, ssm_scan_dtype="bfloat16")
    r16 = rcfg.replace(ssm_chunk=chunk, ssm_scan_dtype="bfloat16")
    got, cache = ssm.apply_mamba1(params, c16, torch.from_numpy(x), return_cache=True)
    want, rcache = rssm.apply_mamba1(rparams, r16, jnp.asarray(x), return_cache=True)
    ctl, ccache = rssm.apply_mamba1(rparams, rcfg.replace(ssm_chunk=chunk), jnp.asarray(x),
                                    return_cache=True)
    for name, g, w, c in (("out", got, want, ctl), ("h", cache["h"], rcache["h"], ccache["h"])):
        control = _l2(w, c)
        assert 0 < _l2(g.numpy(), w) <= BF16_CONTROL_FACTOR * control, (name, _l2(g, w), control)
    np.testing.assert_array_equal(cache["conv"].numpy(), np.asarray(rcache["conv"]))
    f32 = ssm.apply_mamba1(params, cfg.replace(ssm_chunk=chunk), torch.from_numpy(x))
    assert not torch.equal(got, f32)              # the mode rounds
    # the decode step stays f32 whatever the scan's elements
    y16, new16 = ssm.mamba1_decode(params, c16, torch.from_numpy(x[:, :1]), cache)
    y32, new32 = ssm.mamba1_decode(params, cfg, torch.from_numpy(x[:, :1]), cache)
    assert torch.equal(y16, y32) and torch.equal(new16["h"], new32["h"])


def test_bf16_scan_trains_on_a_mesh_as_on_one_device():
    """falcon-mamba SMOKE with ``ssm_scan_dtype="bfloat16"``: one step's
    loss and gradients on a 1x2 mesh (each position scans its own
    channels) against one device, at the mesh tests' f32 tolerances (the
    loss within 1e-5 relative, each gradient within 5e-5 of its largest)."""
    from repro_torch.configs import get_config
    from repro_torch.data.loader import DataLoader
    from repro_torch.models import Model
    from repro_torch.runtime.elastic import make_mesh
    from repro_torch.sharding.placed import gather, place
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.tree import leaves, leaves_with_path, tree_map

    cfg = get_config("falcon-mamba-7b", smoke=True).replace(dtype="float32",
                                                            ssm_scan_dtype="bfloat16")
    params = Model(cfg).init(1, device="cpu")
    loader = DataLoader(cfg, 2, 16, seed=0, device="cpu")
    batch = next(loader)
    loader.close()
    tc = TrainConfig(batch=2, seq_len=16)
    want, want_m = Trainer(cfg, tc, device="cpu").grads_of(params, batch)
    f32, _ = Trainer(cfg.replace(ssm_scan_dtype="float32"), tc, device="cpu").grads_of(params,
                                                                                      batch)
    tr = Trainer(cfg, tc, mesh=make_mesh([torch.device("cpu")] * 2, model_parallel=2))
    got, got_m = tr.mesh_grads_of(tree_map(place, params, tr.state_shardings().params),
                                  tr._microbatches(batch)[0])
    assert abs(float(got_m["loss"]) - float(want_m["loss"])) <= 1e-5 * float(want_m["loss"])
    for (path, g), w in zip(leaves_with_path(got), leaves(want)):
        g = gather(g).double()
        assert float((g - w.double()).abs().max()) <= 5e-5 * float(w.abs().max()), path
    assert any(not torch.equal(a, b) for a, b in zip(leaves(want), leaves(f32)))
