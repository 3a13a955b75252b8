"""The port's continuous-batching ``Engine`` gives the reference ``Engine``'s
tokens on the same weights (carried by ``carry_params``), in the three
cases of ``tests/test_engine.py``: continuous batching, EOS, and more
requests than slots; the same for the MoE archs' and minicpm3-4b's
(MLA) smoke configs, whose bucket-padded prefills drop tokens at the
experts' capacity; for falcon-mamba-7b's smoke config, on
bucket-length prompts, with one-token prompts that keep a used slot's
state and the reference's refusal of other lengths; and for zamba2-2.7b's
(the hybrid: Mamba-2 layers and a shared attention block), on
bucket-length prompts, with every entry of the cache tree copied into a
slot at admission."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import Model as RefModel
from repro.serve import Engine as RefEngine
from repro.serve import Request as RefRequest
from repro_torch.configs import get_config
from repro_torch.models import Model, carry_params
from repro_torch.serve import Engine, Request


@pytest.fixture(scope="module")
def setup():
    rcfg = ref_get_config("llama3.2-1b", smoke=True).replace(dtype="float32")
    cfg = get_config("llama3.2-1b", smoke=True).replace(dtype="float32")
    rparams = RefModel(rcfg).init(jax.random.key(0))
    return cfg, carry_params(jax.tree.map(np.asarray, rparams), cfg, device="cpu"), rcfg, rparams


def _serve(engine_cls, request_cls, cfg, params, reqs, **kw):
    eng = engine_cls(cfg, params, **kw)
    for uid, prompt, n_new, eos in reqs:
        eng.submit(request_cls(uid=uid, prompt=prompt, max_new_tokens=n_new, eos_id=eos))
    done = eng.run()
    return {r.uid: r.output for r in done}, [r.uid for r in done]


def _both(setup, reqs, **kw):
    cfg, params, rcfg, rparams = setup
    got, order = _serve(Engine, Request, cfg, params, reqs, device="cpu", **kw)
    want, ref_order = _serve(RefEngine, RefRequest, rcfg, rparams, reqs, **kw)
    assert order == ref_order    # the same finishing order
    assert got == want
    return got


def test_continuous_batching_matches_reference(setup):
    prompts = [[5, 9, 2, 7], [11, 3], list(range(1, 13)), [42], [13, 14, 15]]
    got = _both(setup, [(i, p, 5, None) for i, p in enumerate(prompts)],
                max_batch=3, max_len=256, prompt_buckets=(8, 16, 32))
    assert sorted(got) == list(range(len(prompts))) and all(len(o) == 5 for o in got.values())


def test_eos_stops_early_as_reference(setup):
    cfg, params = setup[:2]
    free, _ = _serve(Engine, Request, cfg, params, [(0, [5, 9, 2, 7], 8, None)], device="cpu",
                     max_batch=2, max_len=128, prompt_buckets=(8,))
    eos = free[0][2]
    got = _both(setup, [(0, [5, 9, 2, 7], 8, eos)], max_batch=2, max_len=128,
                prompt_buckets=(8,))
    assert got[0] == free[0][:free[0].index(eos) + 1]


def test_more_requests_than_slots_match_reference(setup):
    got = _both(setup, [(i, [i + 1, i + 2], 3, None) for i in range(6)],
                max_batch=2, max_len=128, prompt_buckets=(8,))
    assert sorted(got) == list(range(6))


def test_max_len_stop_and_timings(setup):
    """A slot stops at position max_len - 1 (the trash slot is never
    attended); prefill and decode steps are timed."""
    cfg, params = setup[:2]
    eng = Engine(cfg, params, max_batch=2, max_len=16, prompt_buckets=(8, 16), device="cpu")
    eng.submit(Request(uid=0, prompt=list(range(1, 10)), max_new_tokens=50))
    done = eng.run()
    assert len(done[0].output) == 16 - 1 - 8
    assert len(eng.prefill_ms) == 1 and len(eng.decode_ms) == len(done[0].output)
    _both(setup, [(0, list(range(1, 10)), 50, None)], max_batch=2, max_len=16,
          prompt_buckets=(8, 16))


# ---------------------------------------------------------------------------
# The ssm family: falcon-mamba-7b smoke, bucket-length prompts only
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup_ssm():
    rcfg = ref_get_config("falcon-mamba-7b", smoke=True).replace(dtype="float32")
    cfg = get_config("falcon-mamba-7b", smoke=True).replace(dtype="float32")
    rparams = RefModel(rcfg).init(jax.random.key(0))
    return cfg, carry_params(jax.tree.map(np.asarray, rparams), cfg, device="cpu"), rcfg, rparams


def test_ssm_engine_matches_reference_with_more_requests_than_slots(setup_ssm):
    """Contexts of exactly a bucket's length (the engine's contract for an
    ssm model), six requests through two slots. Requests 3 and 4 have
    one-token prompts, so no context: they are not prefilled and keep
    their slots' old state (the previous occupant's, advanced by the idle
    decode steps), in both packages alike."""
    rng = np.random.default_rng(0)
    lens = [8, 4, 8, 0, 0, 4]
    prompts = [rng.integers(0, 256, n + 1).tolist() for n in lens]
    got = _both(setup_ssm, [(i, p, 4 + i % 3, None) for i, p in enumerate(prompts)],
                max_batch=2, max_len=64, prompt_buckets=(4, 8))
    assert sorted(got) == list(range(6))
    assert all(len(got[i]) == 4 + i % 3 for i in got)


def test_ssm_engine_one_token_prompt_keeps_the_slots_state(setup_ssm):
    """A one-token prompt in a used slot decodes from that slot's stale
    state: its tokens differ from the same prompt in a fresh engine, and
    equal the reference's in the same position."""
    cfg, params = setup_ssm[:2]
    reqs = [(0, list(range(1, 10)), 3, None), (1, [7], 5, None)]
    got = _both(setup_ssm, reqs, max_batch=1, max_len=64, prompt_buckets=(8,))
    fresh, _ = _serve(Engine, Request, cfg, params, [(1, [7], 5, None)], device="cpu",
                      max_batch=1, max_len=64, prompt_buckets=(8,))
    assert got[1] != fresh[1]


def test_ssm_engine_refuses_non_bucket_prompts_as_reference(setup_ssm):
    cfg, params, rcfg, rparams = setup_ssm
    msgs = []
    for engine_cls, request_cls, c, p, kw in ((Engine, Request, cfg, params, {"device": "cpu"}),
                                             (RefEngine, RefRequest, rcfg, rparams, {})):
        eng = engine_cls(c, p, max_batch=2, max_len=64, prompt_buckets=(8, 16, 32, 64), **kw)
        eng.submit(request_cls(uid=0, prompt=list(range(1, 21)), max_new_tokens=2))
        with pytest.raises(ValueError, match="needs bucket-length prompts") as err:
            eng.run()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] == ("ssm engine needs bucket-length prompts; got 19, "
                                  "buckets=(8, 16, 32, 64)")


# ---------------------------------------------------------------------------
# The moe family and MLA: qwen3-moe-30b-a3b, phi3.5-moe-42b-a6.6b, minicpm3-4b
# ---------------------------------------------------------------------------

MOE_MLA = ("qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b", "minicpm3-4b")


@pytest.fixture(scope="module", params=MOE_MLA)
def setup_moe_mla(request):
    """The port's weights from seed 0 (the same in every process, unlike the
    reference's initializer, which salts each leaf's key with ``hash``), so
    that which prefills overflow an expert's capacity is fixed."""
    rcfg = ref_get_config(request.param, smoke=True).replace(dtype="float32")
    cfg = get_config(request.param, smoke=True).replace(dtype="float32")
    params = Model(cfg).init(0, device="cpu")
    return cfg, params, rcfg, jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()), params)


def test_moe_mla_continuous_batching_matches_reference(setup_moe_mla):
    """Bucket-padded prefills (b = 1, the routing group = the bucket, pad
    tokens routed after the prompt's) and decode steps that route every
    slot, idle ones included; MLA's latent cache takes the pad tokens in
    its trash slot."""
    from repro_torch.models import moe

    prompts = [[5, 9, 2, 7], [11, 3], list(range(1, 16)), [42], [13, 14, 15], list(range(30, 60))]
    reqs = [(i, p, 5, None) for i, p in enumerate(prompts)]
    with moe.record_routing() as log:
        got = _both(setup_moe_mla, reqs, max_batch=3, max_len=128, prompt_buckets=(8, 16, 32))
    assert sorted(got) == list(range(len(prompts))) and all(len(o) == 5 for o in got.values())
    cfg = setup_moe_mla[0]
    if cfg.family == "moe":
        # some prefill's expert queue outgrew its capacity: drops were exercised
        over = [int(torch.bincount(idx.flatten(), minlength=cfg.num_experts).max())
                > moe._capacity(idx.shape[0], cfg) for _, idx, _ in log]
        assert any(over)
    else:
        assert not log


def test_moe_mla_more_requests_than_slots_match_reference(setup_moe_mla):
    got = _both(setup_moe_mla, [(i, [i + 1, i + 2, i + 3], 3, None) for i in range(6)],
                max_batch=2, max_len=64, prompt_buckets=(8,))
    assert sorted(got) == list(range(6))


# ---------------------------------------------------------------------------
# The hybrid family: zamba2-2.7b smoke, bucket-length prompts only
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup_hybrid():
    rcfg = ref_get_config("zamba2-2.7b", smoke=True).replace(dtype="float32")
    cfg = get_config("zamba2-2.7b", smoke=True).replace(dtype="float32")
    rparams = RefModel(rcfg).init(jax.random.key(0))
    return cfg, carry_params(jax.tree.map(np.asarray, rparams), cfg, device="cpu"), rcfg, rparams


def test_hybrid_engine_matches_reference_with_more_requests_than_slots(setup_hybrid):
    """Six requests through two slots, contexts of a bucket's exact length
    (one-token prompts included, which keep their slot's state): the same
    tokens and finishing order as the reference's engine."""
    rng = np.random.default_rng(1)
    lens = [8, 4, 16, 0, 8, 4]
    prompts = [rng.integers(0, 256, n + 1).tolist() for n in lens]
    got = _both(setup_hybrid, [(i, p, 3 + i % 3, None) for i, p in enumerate(prompts)],
                max_batch=2, max_len=64, prompt_buckets=(4, 8, 16))
    assert sorted(got) == list(range(6)) and all(len(got[i]) == 3 + i % 3 for i in got)


def test_hybrid_admission_fills_the_slots_shared_cache(setup_hybrid):
    """Admitting a prompt prefills every entry of the cache tree into its
    slot: the shared block's k/v of each group (``shared``) as well as the
    Mamba-2 layers' state (``layers``), equal to a one-slot prefill's, and
    the other slots left at zero."""
    cfg, params = setup_hybrid[:2]
    eng = Engine(cfg, params, max_batch=3, max_len=32, prompt_buckets=(8,), device="cpu")
    prompt = list(range(3, 12))                              # a context of 8 tokens
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=2))
    eng._admit()
    one = Model(cfg).init_cache(1, 33, dtype=torch.float32, device="cpu")
    Model(cfg).prefill(params, {"tokens": torch.tensor([prompt[:-1]], dtype=torch.int32)}, one)
    assert set(eng.cache) == {"layers", "shared"}
    for key in ("layers", "shared"):
        for name, big in eng.cache[key].items():
            assert torch.equal(big[:, 0], one[key][name][:, 0]), f"{key}/{name}"
            assert not big[:, 1:].any(), f"{key}/{name}"
    assert eng.cache["shared"]["k"][:, 0, :8].abs().min() > 0     # 9 groups' keys, 8 positions


def test_hybrid_engine_refuses_non_bucket_prompts_as_reference(setup_hybrid):
    cfg, params, rcfg, rparams = setup_hybrid
    msgs = []
    for engine_cls, request_cls, c, p, kw in ((Engine, Request, cfg, params, {"device": "cpu"}),
                                             (RefEngine, RefRequest, rcfg, rparams, {})):
        eng = engine_cls(c, p, max_batch=2, max_len=64, prompt_buckets=(8, 16, 32, 64), **kw)
        eng.submit(request_cls(uid=0, prompt=list(range(1, 12)), max_new_tokens=2))
        with pytest.raises(ValueError, match="needs bucket-length prompts") as err:
            eng.run()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] == ("hybrid engine needs bucket-length prompts; got 10, "
                                  "buckets=(8, 16, 32, 64)")
