"""K5's plain version, ``selective_scan_plain``, against the reference's
``selective_scan`` (the Pallas kernel in interpret mode) and the numpy
recurrence of ``tests/test_kernels.py``, at the reference test's tolerance
(3e-5 abs + rel): y in the reference test's three (chunk, block_d) cases
and on ragged shapes, the final state against the numpy recurrence's, and
the shape rule refusing what the reference's assert refuses. The CUDA
kernel itself is held to this plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 8)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan import selective_scan as ref_selective_scan
from repro_torch.kernels import selective_scan as k5
from repro_torch.kernels.selective_scan import selective_scan, selective_scan_plain

TOL = 3e-5    # tests/test_kernels.py::test_selective_scan_kernel


def _inputs(shape, seed=0):
    """The reference test's distributions: x, B, C ~ N(0, 1), dt = |N(0, 0.1)|,
    A = -|N(1, 0.3)|."""
    bsz, l, di, n = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (bsz, l, di)).astype(np.float32)
    dt = np.abs(rng.normal(0, 0.1, (bsz, l, di))).astype(np.float32)
    bm = rng.normal(0, 1, (bsz, l, n)).astype(np.float32)
    cm = rng.normal(0, 1, (bsz, l, n)).astype(np.float32)
    a = -np.abs(rng.normal(1, 0.3, (di, n))).astype(np.float32)
    return x, dt, bm, cm, a


def _naive(x, dt, bm, cm, a):
    """tests/test_kernels.py's recurrence in f64, with its final state."""
    bsz, l, di = x.shape
    h = np.zeros((bsz, di, a.shape[-1]))
    ys = []
    for t in range(l):
        da = np.exp(dt[:, t, :, None] * a)
        h = h * da + (dt[:, t] * x[:, t])[..., None] * bm[:, t, None, :]
        ys.append(np.einsum("bdn,bn->bd", h, cm[:, t]))
    return np.stack(ys, 1), h


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("chunk,block_d", [(8, 8), (16, 4), (32, 16)])
def test_plain_matches_reference_kernel_and_recurrence(chunk, block_d):
    arrays = _inputs((2, 32, 16, 4), seed=chunk)
    want = np.asarray(ref_selective_scan(*map(jnp.asarray, arrays), chunk=chunk,
                                         block_d=block_d, interpret=True))
    y, h = selective_scan(*_torch(arrays), chunk=chunk, block_d=block_d)
    ny, nh = _naive(*arrays)
    np.testing.assert_allclose(y.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(y.numpy(), ny, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(h.numpy(), nh, rtol=TOL, atol=TOL)
    assert y.dtype == torch.float32 and h.shape == (2, 16, 4) and h.dtype == torch.float32


@pytest.mark.parametrize("shape", [(2, 7, 24, 1), (1, 1, 200, 4), (2, 7, 200, 16),
                                   (1, 300, 24, 16), (3, 5, 5, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_on_ragged_shapes(shape):
    """Ragged d_inner and N, L of 1 and 7, and an L past the plain version's
    PLAIN_CHUNK, against the reference kernel (interpret mode, whole
    blocks) and the recurrence's y and final state."""
    arrays = _inputs(shape, seed=sum(shape))
    l, di = shape[1], shape[2]
    want = np.asarray(ref_selective_scan(*map(jnp.asarray, arrays), chunk=l, block_d=di,
                                         interpret=True))
    y, h = selective_scan(*_torch(arrays), chunk=l, block_d=di)
    ny, nh = _naive(*arrays)
    np.testing.assert_allclose(y.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(y.numpy(), ny, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(h.numpy(), nh, rtol=TOL, atol=TOL)


def test_plain_takes_bf16_with_f32_math():
    """bf16 inputs are read in f32 and y is rounded once to bf16, as the
    reference kernel does (y in x's dtype); the state stays f32."""
    arrays = _inputs((2, 16, 24, 4), seed=5)
    bf = [torch.from_numpy(a).bfloat16() for a in arrays]
    y, h = selective_scan_plain(*bf)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    wy, wh = selective_scan_plain(*[t.float() for t in bf])
    assert torch.equal(y, wy.bfloat16())
    assert torch.equal(h, wh)
    want = np.asarray(ref_selective_scan(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                           for t in bf), chunk=16, block_d=24,
                                         interpret=True))
    # Both round an f32 result once: one bf16 ulp of the output, plus the
    # f32 tolerance where that ulp is below it (near 0).
    w = want.astype(np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
    assert np.all(np.abs(y.float().numpy() - w) <= ulp + TOL)


@pytest.mark.parametrize("l,di,chunk,block_d", [(32, 16, 12, 8), (32, 16, 8, 6),
                                                (30, 16, 8, 16)])
def test_shape_rule_refuses_what_the_reference_refuses(l, di, chunk, block_d):
    arrays = _inputs((1, l, di, 4))
    with pytest.raises(AssertionError):
        ref_selective_scan(*map(jnp.asarray, arrays), chunk=chunk, block_d=block_d,
                           interpret=True)
    with pytest.raises(ValueError, match="must divide"):
        selective_scan(*_torch(arrays), chunk=chunk, block_d=block_d)


def test_shapes_devices_and_lanes():
    x, dt, bm, cm, a = _torch(_inputs((1, 8, 16, 4)))
    with pytest.raises(ValueError, match="A must be"):
        selective_scan(x, dt, bm, cm, a[:, :3])
    with pytest.raises(ValueError, match="B and C"):
        selective_scan(x, dt, bm[:, :4], cm, a)
    with pytest.raises(ValueError, match="empty"):
        selective_scan(x[:, :0], dt[:, :0], bm[:, :0], cm[:, :0], a)
    with pytest.raises(TypeError):
        selective_scan(x.int(), dt, bm, cm, a)
    with pytest.raises(ValueError, match="backend='cuda'"):
        selective_scan(x, dt, bm, cm, a, backend="cuda")
    before = selective_scan.launches
    y, h = selective_scan(x, dt, bm, cm, a, backend="torch")
    ya, ha = selective_scan(x, dt, bm, cm, a)      # a CPU tensor takes the plain version
    assert torch.equal(y, ya) and torch.equal(h, ha)
    assert selective_scan.launches == before


@pytest.mark.parametrize("n", (33, 64))
def test_plain_matches_reference_past_32_states(n):
    """The reference's kernel has no limit on N: past the 32 states the
    first K5 held, the plain version (the kernel's CPU lane) still matches
    the reference kernel in interpret mode and the recurrence."""
    arrays = _inputs((2, 24, 40, n), seed=n)
    want = np.asarray(ref_selective_scan(*map(jnp.asarray, arrays), chunk=8, block_d=20,
                                         interpret=True))
    y, h = selective_scan(*_torch(arrays), chunk=8, block_d=20)
    ny, nh = _naive(*arrays)
    np.testing.assert_allclose(y.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(y.numpy(), ny, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(h.numpy(), nh, rtol=TOL, atol=TOL)
    assert n <= k5.NMAX and h.shape == (2, 40, n)


# ---------------------------------------------------------------------------
# bf16 scan elements (scan_dtype="bfloat16")
# ---------------------------------------------------------------------------

def _naive_bf16(x, dt, bm, cm, a, q):
    """The bf16-element recurrence in numpy f32 (``ml_dtypes`` rounds to
    bf16): at t % q == 0 hc = h and the chunk restarts from da and bx; then
    A = bf16(A * da), Bc = bf16(da * Bc + bx), h = A * hc + Bc."""
    import ml_dtypes

    def rn(v):
        return v.astype(ml_dtypes.bfloat16).astype(np.float32)

    bsz, l, di = x.shape
    h = np.zeros((bsz, di, a.shape[-1]), np.float32)
    ys = []
    for t in range(l):
        da = rn(np.exp(dt[:, t, :, None] * a))
        bx = rn((dt[:, t] * x[:, t])[..., None] * bm[:, t, None, :])
        if t % q == 0:
            hc, acc_a, acc_b = h, da, bx
        else:
            acc_a, acc_b = rn(acc_a * da), rn(da * acc_b + bx)
        h = acc_a * hc + acc_b
        ys.append((h * cm[:, t, None, :]).sum(-1))
    return np.stack(ys, 1), h


@pytest.mark.parametrize("q", [1, 4, 16])
def test_plain_bf16_elements_follow_the_recurrence(q):
    """The state bit-equal to the numpy recurrence (the same f32 operations
    in the same order), y within the f32 tolerance (numpy sums the states in
    another order); the f32 lane unchanged by the chunk."""
    arrays = _inputs((2, 16, 24, 4), seed=3)
    y, h = selective_scan_plain(*_torch(arrays), scan_dtype="bfloat16", chunk=q)
    ny, nh = _naive_bf16(*arrays, q)
    np.testing.assert_array_equal(h.numpy(), nh)
    np.testing.assert_allclose(y.numpy(), ny, rtol=TOL, atol=TOL)
    wy, wh = selective_scan_plain(*_torch(arrays))
    assert not torch.equal(h, wh)
    assert torch.equal(selective_scan(*_torch(arrays), chunk=q, block_d=24)[0], wy)
    got = selective_scan(*_torch(arrays), chunk=q, block_d=24, scan_dtype="bfloat16")
    assert torch.equal(got[0], y) and torch.equal(got[1], h)


def test_bf16_elements_refusals():
    args = _torch(_inputs((1, 8, 8, 4)))
    with pytest.raises(ValueError, match="scan_dtype='float16'"):
        selective_scan(*args, chunk=8, block_d=8, scan_dtype="float16")
    with pytest.raises(ValueError, match="chunk=3 must divide L=8"):
        selective_scan(*args, chunk=3, block_d=8, scan_dtype="bfloat16")


def test_k5_function_in_bf16_elements_gives_the_plain_gradients(monkeypatch):
    """``k5_scan(scan_dtype="bfloat16")`` with the kernel replaced by a
    counting plain call: one launch in the bf16 mode, and the gradients of
    autograd through the bf16 plain scan (its casts pass gradients through)."""
    calls = []

    def fake(x, dt, b_mat, c_mat, a, **kw):
        calls.append(kw)
        with torch.no_grad():
            return selective_scan_plain(x, dt, b_mat, c_mat, a, **kw)

    monkeypatch.setattr(k5, "_launch", fake)
    args = [t.requires_grad_(True) for t in _torch(_inputs((2, 8, 16, 4), seed=9))]
    g = torch.Generator().manual_seed(0)
    gy, gh = torch.randn((2, 8, 16), generator=g), torch.randn((2, 16, 4), generator=g)
    y, h = k5.k5_scan(*args, chunk=4, block_d=16, scan_dtype="bfloat16")
    assert calls == [dict(scan_dtype="bfloat16", chunk=4)]
    got = torch.autograd.grad((y, h), args, (gy, gh))
    wy, wh = selective_scan_plain(*args, scan_dtype="bfloat16", chunk=4)
    assert torch.equal(y, wy.detach()) and torch.equal(h, wh.detach())
    want = torch.autograd.grad((wy, wh), args, (gy, gh))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    k5.k5_scan(*[t.detach() for t in args], chunk=4, block_d=16)
    assert calls[-1] == dict(scan_dtype="float32", chunk=4)
