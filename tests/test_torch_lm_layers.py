"""The port's model layers against ``repro.models.layers`` on the same numpy
inputs: norms (all three types), MLP (SwiGLU and GELU), RoPE, embeddings,
and the spec system."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as R
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

# f32 on both sides; the sums run in another order (XLA vs ATen).
TOL = 1e-5


def _cfgs(**kw):
    return (get_config("llama3.2-1b", smoke=True).replace(**kw),
            ref_get_config("llama3.2-1b", smoke=True).replace(**kw))


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm", "layernorm_np"])
def test_norm_matches_reference(norm_type):
    cfg, rcfg = _cfgs(norm_type=norm_type)
    rng = np.random.default_rng(0)
    x = (rng.normal(0, 3, (2, 5, cfg.d_model)) + 1.5).astype(np.float32)
    params = {k: rng.normal(1, 0.2, s.shape).astype(np.float32)
              for k, s in L.norm_params(cfg).items()}
    assert {k: s.shape for k, s in L.norm_params(cfg).items()} == \
        {k: s.shape for k, s in R.norm_params(rcfg).items()}
    want = np.asarray(R.apply_norm({k: jnp.asarray(v) for k, v in params.items()}, rcfg,
                                   jnp.asarray(x)))
    got = L.apply_norm({k: torch.from_numpy(v) for k, v in params.items()}, cfg,
                       torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_mlp_matches_reference(mlp_type):
    cfg, rcfg = _cfgs(mlp_type=mlp_type)
    specs = L.mlp_params(cfg)
    assert {k: (s.shape, s.axes) for k, s in specs.items()} == \
        {k: (s.shape, s.axes) for k, s in R.mlp_params(rcfg).items()}
    rng = np.random.default_rng(1)
    params = {k: (rng.normal(0, 1, s.shape) / np.sqrt(s.shape[0])).astype(np.float32)
              for k, s in specs.items()}
    x = rng.normal(0, 1, (2, 3, cfg.d_model)).astype(np.float32)
    want = np.asarray(R.apply_mlp({k: jnp.asarray(v) for k, v in params.items()}, rcfg,
                                  jnp.asarray(x)))
    got = L.apply_mlp({k: torch.from_numpy(v) for k, v in params.items()}, cfg,
                      torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("head_dim,theta", [(8, 500_000.0), (16, 10_000.0), (64, 500_000.0)])
def test_rope_matches_reference(head_dim, theta):
    np.testing.assert_array_equal(L.rope_frequencies(head_dim, theta),
                                  R.rope_frequencies(head_dim, theta))
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 300, 3, head_dim)).astype(np.float32)
    pos = np.stack([np.arange(300), np.arange(300) * 7 + 11]).astype(np.int32)
    want = np.asarray(R.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    # cos/sin of angles up to ~2000 rad: XLA and torch may differ by an ulp
    # of the angle's cosine (~1e-7 absolute); products with |x| <~ 5.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-5)
    # the shared-head (B, S, D) form
    want3 = np.asarray(R.apply_rope(jnp.asarray(x[:, :, 0]), jnp.asarray(pos), theta))
    got3 = L.apply_rope(torch.from_numpy(x[:, :, 0]), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got3.numpy(), want3, rtol=1e-5, atol=2e-5)


def test_embed_and_unembed_match_reference():
    cfg, rcfg = _cfgs()
    assert {k: (s.shape, s.axes, s.init) for k, s in L.embed_params(cfg).items()} == \
        {k: (s.shape, s.axes, s.init) for k, s in R.embed_params(rcfg).items()}
    rng = np.random.default_rng(3)
    table = rng.normal(0, 0.02, (cfg.vocab_size, cfg.d_model)).astype(np.float32)
    head = rng.normal(0, 0.1, (cfg.d_model, cfg.vocab_size)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)
    rp = {"embed": {"embedding": jnp.asarray(table), "lm_head": jnp.asarray(head)}}
    tp = {"embed": {"embedding": torch.from_numpy(table), "lm_head": torch.from_numpy(head)}}
    x = RT.embed_tokens(rp, rcfg, jnp.asarray(tokens), jnp.float32)
    got = T.embed_tokens(tp, cfg, torch.from_numpy(tokens), torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(x))
    np.testing.assert_allclose(T.unembed(tp, cfg, got).numpy(),
                               np.asarray(RT.unembed(rp, rcfg, x)), rtol=TOL, atol=TOL)


def test_stack_specs_and_init_tree():
    cfg, rcfg = _cfgs()
    specs = L.stack_specs(L.mlp_params(cfg), 3)
    ref = R.stack_specs(R.mlp_params(rcfg), 3)
    assert {k: tuple(s) for k, s in specs.items()} == {k: tuple(s) for k, s in ref.items()}
    tree = {"a": specs, "norm": {"scale": L.Spec((4,), ("embed",), "ones")},
            "emb": L.Spec((50, 64), ("vocab", "embed"), "normal")}
    w1, w2 = L.init_tree(tree, 0), L.init_tree(tree, 0)
    w3 = L.init_tree(tree, 1)
    for k in ("w_up", "w_gate", "w_down"):
        assert w1["a"][k].shape == specs[k].shape
        assert torch.equal(w1["a"][k], w2["a"][k])           # same seed, same weights
        assert not torch.equal(w1["a"][k], w3["a"][k])       # another seed, others
        std = float(w1["a"][k].std())
        # fan_in divides by shape[0], the layer axis of a stacked spec, as
        # the reference's _init_leaf does
        assert abs(std - 1 / np.sqrt(specs[k].shape[0])) < 0.1 * std
    assert not torch.equal(w1["a"]["w_up"], w1["a"]["w_gate"])   # another path, others
    assert torch.equal(w1["norm"]["scale"], torch.ones(4))
    assert abs(float(w1["emb"].std()) - 0.02) < 0.002


def test_init_tree_is_stable_across_processes():
    """The reference salts its per-leaf seeds with Python's per-process hash;
    the port's crc32 seeds give the same first weights in a fresh process."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = ("from repro_torch.models.layers import Spec, init_tree; "
            "print(float(init_tree({'w': {'x': Spec((4, 4), (None, None))}}, 7)['w']['x'].sum()))")
    env = dict(os.environ, PYTHONPATH=str(root / "src"), PYTHONHASHSEED="random")
    outs = {subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                           env=env, timeout=120, check=True).stdout for _ in range(2)}
    here = float(L.init_tree({"w": {"x": L.Spec((4, 4), (None, None))}}, 7)["w"]["x"].sum())
    assert outs == {f"{here}\n"}
