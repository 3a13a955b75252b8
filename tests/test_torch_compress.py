"""The port's compressed all-reduce (``optim/compress.py``) against the
reference's ``repro.optim.compress``, over 1, 2 and 4 shards.

The reference runs under ``jax.vmap`` with a named axis (its ``psum`` and
``pmax`` then reduce over the mapped shards, as under ``shard_map``); the
port's shards are the positions of a :class:`Placed` leaf along the mesh
axis. The results must be equal bit for bit, and the reference's own two
properties (``tests/test_optim.py``) must hold for the port."""
import jax
import numpy as np
import pytest
import torch

from repro.optim.compress import compress_tree_psum as ref_tree_psum
from repro.optim.compress import compressed_psum as ref_psum
from repro_torch.optim.compress import compress_tree_psum, compressed_psum, init_error_state
from repro_torch.runtime.elastic import make_mesh
from repro_torch.sharding.placed import Placed
from repro_torch.sharding.rules import PartitionSpec

CPU = torch.device("cpu")


def _placed(mesh, values: np.ndarray, axis_index: int) -> Placed:
    """Shard ``i`` along the mesh's ``axis_index`` holds ``values[i]``."""
    return Placed(mesh, PartitionSpec(), values.shape[1:],
                  {pos: torch.from_numpy(values[pos[axis_index]].copy())
                   for pos in mesh.positions()})


def _stacked(placed: Placed, mesh, axis_index: int, n: int) -> np.ndarray:
    by_index = {}
    for pos in mesh.positions():
        by_index.setdefault(pos[axis_index], placed.local(pos).numpy())
        assert np.array_equal(by_index[pos[axis_index]], placed.local(pos).numpy())
    return np.stack([by_index[i] for i in range(n)])


def _inputs(n, bits, shape=(64,)):
    rng = np.random.default_rng(100 * n + bits)
    scale = rng.uniform(0.1, 10.0, (n,) + (1,) * len(shape)).astype(np.float32)
    return rng.standard_normal((n,) + shape).astype(np.float32) * scale


@pytest.mark.parametrize("bits", [4, 8, 12])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_compressed_psum_is_the_references_bit_for_bit(n, bits):
    x = _inputs(n, bits, (3, 40))
    want = np.asarray(jax.vmap(lambda v: ref_psum(v, "d", bits=bits), axis_name="d")(x))
    # the shards along `model` of a (2, n) mesh: two groups, each reduced alone
    mesh = make_mesh([CPU] * (2 * n), model_parallel=n)
    got = compressed_psum(_placed(mesh, x, 1), "model", bits=bits)
    assert got.local((0, 0)).dtype == torch.float32
    np.testing.assert_array_equal(_stacked(got, mesh, 1, n), want)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_compress_tree_psum_is_the_references_bit_for_bit(n, bits):
    g = {"w": _inputs(n, bits), "b": _inputs(n, bits + 1, (5, 7))}
    e = {k: 0.01 * _inputs(n, bits + 2, v.shape[1:]) for k, v in g.items()}
    want_red, want_err = jax.vmap(lambda gg, ee: ref_tree_psum(gg, ee, "d", bits=bits),
                                  axis_name="d")(g, e)
    mesh = make_mesh([CPU] * n, model_parallel=1)        # (n, 1): shards along `data`
    got_red, got_err = compress_tree_psum({k: _placed(mesh, v, 0) for k, v in g.items()},
                                          {k: _placed(mesh, v, 0) for k, v in e.items()},
                                          "data", bits=bits)
    for k in g:
        np.testing.assert_array_equal(_stacked(got_red[k], mesh, 0, n), np.asarray(want_red[k]))
        np.testing.assert_array_equal(_stacked(got_err[k], mesh, 0, n), np.asarray(want_err[k]))


@pytest.mark.parametrize("seed", range(8))
def test_compressed_psum_error_bound(seed):
    """One shard: the quantized sum is within half a quantization step."""
    mesh = make_mesh([CPU], model_parallel=1)
    x = np.random.default_rng(seed).standard_normal((1, 64)).astype(np.float32)
    out = compressed_psum(_placed(mesh, x, 0), "data", bits=8).local((0, 0)).numpy()
    step = float(np.abs(x).max()) / 127.0
    assert np.max(np.abs(out - x[0])) <= step * 0.5 + 1e-6


def test_error_feedback_telescopes():
    """The mean of 50 compressed 4-bit updates converges to the gradient."""
    mesh = make_mesh([CPU] * 2, model_parallel=1)
    g = np.random.default_rng(0).standard_normal((2, 32)).astype(np.float32)
    grads = {"w": _placed(mesh, g, 0)}
    err = init_error_state(grads)
    assert err["w"].local((1, 0)).dtype == torch.float32 and not err["w"].local((1, 0)).any()
    total = np.zeros(32, np.float32)
    for _ in range(50):
        red, err = compress_tree_psum(grads, err, "data", bits=4)
        total = total + red["w"].local((0, 0)).numpy()
    np.testing.assert_allclose(total / 50, g.mean(axis=0), atol=0.02)
