"""The port's ``PagedKVCache`` (``repro_torch.serve.paged``) against the
reference's (``repro.serve.paged``) on the same calls: the reference's five
cases and its allocator invariants (``tests/test_paged_cache.py``), each
run through both managers on the same seeded numpy inputs. Block tables
are equal, ``gather`` is bit-equal (``assert_array_equal``), and both
raise the same ``MemoryError`` and ``KeyError``. Then a SMOKE llama
prefill's cache, paged and gathered, equals its slot's rows bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.paged import PagedKVCache as RefPaged
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.serve import PagedKVCache
from repro_torch.serve import paged as paged_mod

LAYERS, KV, HD = 2, 2, 4


class Both:
    """One reference manager and one port manager, driven by the same calls."""

    def __init__(self, num_blocks=8, block_size=4):
        kw = dict(layers=LAYERS, kv_heads=KV, head_dim=HD, num_blocks=num_blocks,
                  block_size=block_size)
        self.ref = RefPaged(**kw)
        self.port = PagedKVCache(**kw, device="cpu")

    def call(self, name, *args):
        """``name`` on both, numpy args as each one's arrays; both raise the
        same exception type or neither does."""
        outs, errs = [], []
        for mgr, conv in ((self.ref, jnp.asarray), (self.port, torch.from_numpy)):
            a = [conv(x) if isinstance(x, np.ndarray) else x for x in args]
            try:
                outs.append(getattr(mgr, name)(*a))
                errs.append(None)
            except (MemoryError, KeyError) as e:
                outs.append(None)
                errs.append(type(e))
        assert errs[0] == errs[1], (name, errs)
        if errs[0] is not None:
            raise errs[0]("both managers raised")
        return outs

    def check(self, seq_id):
        """Block tables equal, gathers bit-equal, the same accounting."""
        ref_t, port_t = self.call("block_table", seq_id)
        assert port_t.dtype == torch.int32 and port_t.device.type == "cpu"
        np.testing.assert_array_equal(port_t.numpy(), np.asarray(ref_t))
        (rk, rv), (pk, pv) = self.call("gather", seq_id)
        np.testing.assert_array_equal(pk.numpy(), np.asarray(rk))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
        assert self.port.free_blocks == self.ref.free_blocks
        assert self.port.used_blocks() == self.ref.used_blocks()
        assert self.port.utilization(seq_id) == self.ref.utilization(seq_id)
        assert self.port.length(seq_id) == self.ref.length(seq_id)
        return pk, pv


def _tok(rng):
    return rng.normal(0, 1, (LAYERS, KV, HD)).astype(np.float32)


def test_append_gather_roundtrip(rng):
    c = Both()
    c.call("allocate", 0)
    toks = [(_tok(rng), _tok(rng)) for _ in range(10)]
    for k, v in toks:
        c.call("append", 0, k, v)
    k_seq, v_seq = c.check(0)
    assert tuple(k_seq.shape) == (LAYERS, 10, KV, HD)
    for t, (k, v) in enumerate(toks):
        np.testing.assert_array_equal(k_seq[:, t].numpy(), k)
        np.testing.assert_array_equal(v_seq[:, t].numpy(), v)


def test_prompt_bulk_equals_tokenwise(rng):
    a, b = Both(), Both()
    a.call("allocate", 0)
    b.call("allocate", 0)
    ks = rng.normal(0, 1, (LAYERS, 9, KV, HD)).astype(np.float32)
    vs = rng.normal(0, 1, (LAYERS, 9, KV, HD)).astype(np.float32)
    a.call("append_prompt", 0, ks, vs)
    for t in range(9):
        b.call("append", 0, ks[:, t], vs[:, t])
    np.testing.assert_array_equal(a.check(0)[0].numpy(), b.check(0)[0].numpy())
    assert a.port.length(0) == b.port.length(0) == 9


def test_prompt_after_tokens_crosses_blocks(rng):
    """A prompt appended at an offset inside a block, spanning three more:
    the block-wise loop writes each piece where the reference's does."""
    c = Both(num_blocks=8, block_size=4)
    c.call("allocate", 3)
    for _ in range(3):
        c.call("append", 3, _tok(rng), _tok(rng))
    ks = rng.normal(0, 1, (LAYERS, 11, KV, HD)).astype(np.float32)
    c.call("append_prompt", 3, ks, ks + 1)
    c.check(3)
    assert c.port.length(3) == 14


def test_block_accounting_and_reuse(rng):
    c = Both(num_blocks=4, block_size=4)
    c.call("allocate", 0)
    for _ in range(8):                       # 2 blocks
        c.call("append", 0, _tok(rng), _tok(rng))
    assert c.port.used_blocks() == 2 and c.port.free_blocks == 2
    c.call("allocate", 1)
    for _ in range(5):                       # 2 more blocks
        c.call("append", 1, _tok(rng), _tok(rng))
    assert c.port.free_blocks == 0
    c.check(1)
    c.call("free", 0)
    assert c.port.free_blocks == 2           # blocks recycled
    c.call("allocate", 2)
    for _ in range(8):
        c.call("append", 2, _tok(rng), _tok(rng))    # reuses freed blocks
    assert c.port.free_blocks == 0
    c.check(2)


def test_oom_raises(rng):
    c = Both(num_blocks=1, block_size=2)
    c.call("allocate", 0)
    c.call("append", 0, _tok(rng), _tok(rng))
    c.call("append", 0, _tok(rng), _tok(rng))
    with pytest.raises(MemoryError):
        c.call("append", 0, _tok(rng), _tok(rng))
    c.check(0)


def test_double_allocate_rejected():
    c = Both()
    c.call("allocate", 0)
    with pytest.raises(KeyError):
        c.call("allocate", 0)
    with pytest.raises(KeyError):
        c.call("free", 1)


def test_empty_sequence_gathers_zero_rows():
    c = Both()
    c.call("allocate", 0)
    k, v = c.check(0)
    assert tuple(k.shape) == tuple(v.shape) == (LAYERS, 0, KV, HD)
    assert c.port.utilization(0) == 1.0


def test_defaults_to_the_card(monkeypatch):
    """``device=None`` asks for the CUDA device: with none it raises, and
    nothing falls back to the CPU."""
    monkeypatch.setattr(paged_mod, "resolve_device",
                        lambda d: (_ for _ in ()).throw(RuntimeError(f"asked for {d}")))
    with pytest.raises(RuntimeError, match="asked for None"):
        PagedKVCache(layers=1, kv_heads=1, head_dim=1)


def test_writes_in_place_keep_the_store(rng):
    """``append`` and ``append_prompt`` write into the same storage; they do
    not rebuild the store."""
    c = PagedKVCache(layers=LAYERS, kv_heads=KV, head_dim=HD, num_blocks=4, block_size=4,
                     device="cpu")
    ptr = (c.k.data_ptr(), c.v.data_ptr())
    c.allocate(0)
    c.append_prompt(0, torch.from_numpy(rng.normal(0, 1, (LAYERS, 6, KV, HD)).astype(np.float32)),
                    torch.zeros((LAYERS, 6, KV, HD)))
    c.append(0, torch.ones((LAYERS, KV, HD)), torch.ones((LAYERS, KV, HD)))
    assert (c.k.data_ptr(), c.v.data_ptr()) == ptr


def _allocator_trace(ops):
    """Random alloc/append/free traces on both managers: no block leaked or
    double-owned, the same block tables and gathers at every step."""
    rng = np.random.default_rng(0)
    c = Both(num_blocks=6, block_size=2)
    live = {}
    for op, sid in ops:
        if op == "alloc" and sid not in live:
            c.call("allocate", sid)
            live[sid] = 0
        elif op == "append" and sid in live:
            try:
                c.call("append", sid, _tok(rng), _tok(rng))
                live[sid] += 1
            except MemoryError:
                pass
        elif op == "free" and sid in live:
            c.call("free", sid)
            live.pop(sid)
        owned = list(c.port._free)
        for s in c.port._seqs.values():
            owned.extend(s.blocks)
        assert sorted(owned) == sorted(set(owned))
        assert len(owned) == c.port.num_blocks
        assert c.port._free == c.ref._free
        for sid2, n in live.items():
            assert c.port.length(sid2) == n
            c.check(sid2)


def test_allocator_trace_fixed():
    """A fixed trace that runs out of blocks, frees, and reuses them."""
    _allocator_trace([("alloc", 0), ("alloc", 1)] + [("append", 0)] * 7 + [("append", 1)] * 8
                     + [("free", 0), ("alloc", 2)] + [("append", 2)] * 5 + [("append", 1)] * 2)


def test_allocator_invariants():
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=20, deadline=None)
    @hypothesis.given(st.lists(st.tuples(st.sampled_from(["alloc", "append", "free"]),
                                         st.integers(0, 3)), min_size=1, max_size=40))
    def run(ops):
        _allocator_trace(ops)

    run()


def test_llama_prefill_cache_pages_bit_equal():
    """A SMOKE llama prefill of two ragged prompts into a batched cache;
    each slot's k/v rows appended to a paged cache (block_size 4) as a
    prompt, then one more row each as a token: the gathers equal the slot
    rows bit for bit."""
    cfg = get_config("llama3.2-1b", smoke=True).replace(dtype="float32")
    model = Model(cfg)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(3)
    lens = (7, 13)
    cache = model.init_cache(2, 16, dtype=torch.float32, device="cpu")
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, max(lens))).astype(np.int32))
    model.prefill(params, {"tokens": tokens}, cache)
    paged = PagedKVCache(layers=cfg.num_layers, kv_heads=cfg.num_kv_heads,
                         head_dim=cfg.head_dim, num_blocks=8, block_size=4, device="cpu")
    for slot, n in enumerate(lens):
        paged.allocate(slot)
        paged.append_prompt(slot, cache["layers"]["k"][:, slot, :n], cache["layers"]["v"][:, slot, :n])
        paged.append(slot, cache["layers"]["k"][:, slot, n], cache["layers"]["v"][:, slot, n])
    for slot, n in enumerate(lens):
        k, v = paged.gather(slot)
        assert torch.equal(k, cache["layers"]["k"][:, slot, :n + 1])
        assert torch.equal(v, cache["layers"]["v"][:, slot, :n + 1])
    assert paged.used_blocks() == 2 + 4 and paged.free_blocks == 2
