"""The port's AdamW (``optim/adamw.py``) and LR schedules
(``optim/schedule.py``) against ``repro.optim`` on the same numpy inputs:
several steps with clipping on and off, the global norm, the moments, the
count and the schedules, each in f32 at the tolerance stated by its test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as radamw
from repro.optim.schedule import constant as rconstant
from repro.optim.schedule import warmup_cosine as rwarmup_cosine
from repro_torch.optim import AdamWState, adamw, constant, global_norm, warmup_cosine
from repro_torch.tree import leaves_with_path

# f32, the same operations in the same order; XLA and PyTorch may round
# pow, sqrt and the norm's sum by an ulp, which Adam's division keeps.
TOL = 2e-6
SHAPES = {"a": {"w": (3, 5), "b": (5,)}, "emb": (7, 4), "s": ()}


def _tree(rng, scale=1.0):
    def make(shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"a": {k: make(s) for k, s in SHAPES["a"].items()}, "emb": make(SHAPES["emb"]),
            "s": make(SHAPES["s"])}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def _assert_trees_close(got, want, tol=TOL):
    want = dict(leaves_with_path(jax.tree.map(np.asarray, want)))
    got = leaves_with_path(got)
    assert sorted(p for p, _ in got) == sorted(want)
    for path, leaf in got:
        np.testing.assert_allclose(leaf.numpy(), want[path], rtol=tol, atol=tol, err_msg=str(path))


@pytest.mark.parametrize("clip_norm", [None, 1.0, 1e3], ids=["no-clip", "clip", "clip-idle"])
def test_update_matches_reference_over_steps(clip_norm):
    """Five steps from the same params and grads (the grads' norm ~ 6, so
    ``clip_norm=1`` scales them and 1e3 leaves them): params, moments,
    count and the pre-clip grad norm."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    rp, p = _jax(params), _torch(params)
    rs, s = radamw.init(rp), adamw.init(p)
    for i in range(5):
        g = _tree(rng)
        lr = 1e-2 * (i + 1)
        rp, rs, rstats = radamw.update(_jax(g), rs, rp, jnp.float32(lr), clip_norm=clip_norm)
        p, s, stats = adamw.update(_torch(g), s, p, lr, clip_norm=clip_norm)
        _assert_trees_close(p, rp)
        _assert_trees_close(s.mu, rs.mu)
        _assert_trees_close(s.nu, rs.nu)
        assert int(s.count) == int(rs.count) == i + 1 and s.count.dtype == torch.int32
        np.testing.assert_allclose(float(stats["grad_norm"]), float(rstats["grad_norm"]),
                                   rtol=TOL)


def test_update_hyperparameters_match_reference():
    rng = np.random.default_rng(1)
    params, g = _tree(rng), _tree(rng, scale=1e-3)
    kw = dict(b1=0.8, b2=0.99, eps=1e-6, weight_decay=0.0, clip_norm=None)
    rp, rs, _ = radamw.update(_jax(g), radamw.init(_jax(params)), _jax(params),
                              jnp.float32(3e-3), **kw)
    p, s, _ = adamw.update(_torch(g), adamw.init(_torch(params)), _torch(params), 3e-3, **kw)
    _assert_trees_close(p, rp)
    _assert_trees_close(s.nu, rs.nu)


def test_update_leaves_its_inputs_and_keeps_dtypes():
    """Functional, as the reference's: a retried step reuses the old
    params and state."""
    rng = np.random.default_rng(2)
    p = _torch(_tree(rng))
    s = adamw.init(p)
    before = [t.clone() for _path, t in leaves_with_path((p, s))]
    new_p, new_s, _ = adamw.update(_torch(_tree(rng)), s, p, 0.1)
    after = [t for _path, t in leaves_with_path((p, s))]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert isinstance(new_s, AdamWState) and int(new_s.count) == 1
    assert all(t.dtype == torch.float32 for _path, t in leaves_with_path(new_p))


def test_global_norm_matches_reference():
    tree = _tree(np.random.default_rng(3), scale=3.0)
    np.testing.assert_allclose(float(global_norm(_torch(tree))),
                               float(radamw.global_norm(_jax(tree))), rtol=1e-7)


def test_adamw_converges_on_quadratic():
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = adamw.init(params)
    for _ in range(300):
        grads = {"w": 2 * (params["w"] - target)}
        params, state, _ = adamw.update(grads, state, params, 0.05, weight_decay=0.0)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=1e-2)


def test_grad_clipping_reports_the_preclip_norm():
    params = {"w": torch.zeros(4)}
    state = adamw.init(params)
    new, _, stats = adamw.update({"w": torch.full((4,), 1e6)}, state, params, 0.1, clip_norm=1.0)
    assert float(stats["grad_norm"]) == pytest.approx(2e6)
    assert torch.isfinite(new["w"]).all()


@pytest.mark.parametrize("warmup,total,final", [(10, 100, 0.1), (20, 8, 0.1), (0, 50, 0.0),
                                                (2, 14, 0.25)])
def test_warmup_cosine_matches_reference(warmup, total, final):
    """Every step through the end and past it, within one f32 ulp, or 1e-7
    of the peak where ``1 + cos`` cancels near the end (the libraries' f32
    cosines may part by an ulp of the cosine)."""
    for step in range(total + 5):
        want = float(rwarmup_cosine(step, peak_lr=3e-4, warmup_steps=warmup, total_steps=total,
                                    final_frac=final))
        got = warmup_cosine(step, peak_lr=3e-4, warmup_steps=warmup, total_steps=total,
                            final_frac=final)
        assert got == pytest.approx(want, rel=2 ** -22, abs=3e-4 * 1e-7), step
    assert warmup_cosine(0, peak_lr=1.0, warmup_steps=5, total_steps=10) == 0.0


def test_schedule_shape():
    lrs = [warmup_cosine(s, peak_lr=1.0, warmup_steps=10, total_steps=100) for s in range(100)]
    assert lrs[0] < lrs[9] <= 1.0
    assert abs(lrs[10] - 1.0) < 0.02
    assert lrs[-1] < 0.2
    assert all(lr >= 0 for lr in lrs)


def test_constant_matches_reference():
    for step in (0, 7, 1000):
        assert constant(step, peak_lr=3e-4, warmup_steps=5) == float(rconstant(step, peak_lr=3e-4))
