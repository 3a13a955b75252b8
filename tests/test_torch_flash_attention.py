"""K4's plain version and wrapper against the reference's Pallas kernel.

``flash_attention_plain`` is what the CUDA kernel is held to on the card;
here it is held to ``repro.kernels.flash_attention.flash_attention`` run
with ``interpret=True`` (the reference's own CPU lane) and to the
reference model's ``dot_attention`` on folded GQA inputs, at the
reference test's tolerance (2e-5). The wrapper refuses what the reference
refuses, and a CUDA-only call raises on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.models.attention import dot_attention as ref_dot_attention
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

TOL = 2e-5   # tests/test_kernels.py::test_flash_attention_kernel

# (B, H, S, T, D), (block_q, block_kv), causal: the reference test's four
# cases, then ragged lengths (one block each) and the model's head dims.
CASES = [
    ((2, 3, 16, 16, 8), (4, 4), True),
    ((1, 2, 32, 32, 16), (8, 16), True),
    ((2, 2, 8, 24, 8), (8, 8), False),
    ((1, 1, 64, 64, 4), (16, 32), True),
    ((1, 2, 7, 7, 8), (7, 7), True),
    ((1, 1, 65, 65, 16), (65, 65), True),
    ((1, 2, 1, 1, 8), (1, 1), True),
    ((1, 2, 5, 13, 8), (5, 13), False),
    ((1, 2, 16, 16, 64), (8, 8), True),
    ((1, 1, 16, 16, 128), (16, 16), True),
]


def _qkv(shape, seed=0):
    b, h, s, t, d = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, h, s, d)).astype(np.float32),
            rng.normal(0, 1, (b, h, t, d)).astype(np.float32),
            rng.normal(0, 1, (b, h, t, d)).astype(np.float32))


@pytest.mark.parametrize("shape,blocks,causal", CASES,
                         ids=lambda c: "x".join(map(str, c)) if isinstance(c, tuple) else str(c))
def test_plain_matches_reference_kernel(shape, blocks, causal):
    q, k, v = _qkv(shape)
    want = np.asarray(ref_flash(*map(jnp.asarray, (q, k, v)), causal=causal,
                                block_q=blocks[0], block_kv=blocks[1], interpret=True))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          block_q=blocks[0], block_kv=blocks[1])
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_plain_bf16_within_one_ulp_of_reference():
    """bf16 in, f32 math, bf16 out: the two round once each, so they may
    differ by one bf16 ulp of the output."""
    q, k, v = _qkv((1, 2, 16, 16, 8), seed=3)
    want = np.asarray(ref_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                block_q=8, block_kv=8, interpret=True).astype(jnp.float32))
    got = flash_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                          block_q=8, block_kv=8)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp)


def test_plain_matches_model_core_on_folded_gqa():
    """As tests/test_kernels.py::test_flash_attention_matches_model_core:
    fold (KV, G) into H, repeat the KV heads, compare with dot_attention."""
    b, kv, g, s, d = 2, 2, 2, 16, 8
    rng = np.random.default_rng(1)
    q5 = rng.normal(0, 1, (b, s, kv, g, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, s, kv, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, s, kv, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    ref = np.asarray(ref_dot_attention(jnp.asarray(q5), jnp.asarray(k), jnp.asarray(v),
                                       pos_q=jnp.asarray(pos), pos_k=jnp.asarray(pos),
                                       causal=True, impl="dense"))
    qh = torch.from_numpy(q5).permute(0, 2, 3, 1, 4).reshape(b, kv * g, s, d)
    kh = torch.from_numpy(k).permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    vh = torch.from_numpy(v).permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    out = flash_attention(qh, kh, vh, causal=True, block_q=8, block_kv=8)
    out = out.reshape(b, kv, g, s, d).permute(0, 3, 1, 2, 4)
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("s,t,bq,bkv", [(16, 16, 6, 8), (16, 24, 8, 16), (12, 12, 8, 4)])
def test_refuses_what_the_reference_refuses(s, t, bq, bkv):
    q, k, v = _qkv((1, 1, s, t, 8))
    with pytest.raises(AssertionError):
        ref_flash(*map(jnp.asarray, (q, k, v)), block_q=bq, block_kv=bkv, interpret=True)
    with pytest.raises(ValueError, match="must divide"):
        flash_attention(*map(torch.from_numpy, (q, k, v)), block_q=bq, block_kv=bkv)


def test_rejects_mismatched_shapes_and_dtypes():
    q, k, v = map(torch.from_numpy, _qkv((1, 2, 8, 8, 8)))
    with pytest.raises(ValueError, match="repeat KV heads"):
        flash_attention(q, k[:, :1], v[:, :1])
    with pytest.raises(ValueError):
        flash_attention(q[0], k[0], v[0])
    with pytest.raises(TypeError):
        flash_attention(q.to(torch.int32), k, v)


def test_cuda_only_call_raises_on_the_cpu():
    q, k, v = map(torch.from_numpy, _qkv((1, 2, 8, 8, 8)))
    before = flash_attention.launches
    with pytest.raises(ValueError, match="needs a CUDA device"):
        flash_attention(q, k, v, backend="cuda")
    assert torch.equal(flash_attention(q, k, v, backend="torch"), flash_attention_plain(q, k, v))
    assert flash_attention.launches == before
