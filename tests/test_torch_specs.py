"""The port's dry-run cell definitions (``repro_torch.launch.specs``) and
shape set (``repro_torch.configs.base.SHAPES``) against the reference's
(``repro.launch.specs``, ``repro.configs.base``), for every arch (sobel-hd
included) and every shape: the same cell plan (skip reasons letter for
letter), ``meta`` input stand-ins of the reference's ``ShapeDtypeStruct``
shapes and dtypes, the same logical axes of the batch and of the cache
(at ``model`` sizes 1, 2 and 16), and an abstract cache of the
reference's ``jax.eval_shape`` shapes and dtypes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import SHAPES as REF_SHAPES
from repro.launch import specs as ref_specs
from repro_torch.configs import SHAPES, ShapeConfig, get_config, list_archs
from repro_torch.launch import specs
from repro_torch.models import Model

ARCHS = list(list_archs())
LM_ARCHS = [a for a in ARCHS if get_config(a).family != "image"]
_DTYPES = {jnp.int32: torch.int32, jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _torch_dtype(dt) -> torch.dtype:
    return {np.dtype(k): v for k, v in _DTYPES.items()}[np.dtype(dt)]


def _flat(tree, prefix=()):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def test_shapes_are_the_references():
    assert list(SHAPES) == list(REF_SHAPES)
    for name, sh in SHAPES.items():
        ref = REF_SHAPES[name]
        assert isinstance(sh, ShapeConfig)
        assert (sh.name, sh.seq_len, sh.global_batch, sh.kind, sh.is_decode) == (
            ref.name, ref.seq_len, ref.global_batch, ref.kind, ref.is_decode)


def test_sobel_shapes_are_the_references():
    assert specs.SOBEL_SHAPES == ref_specs.SOBEL_SHAPES


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_plan_matches_reference(arch):
    assert specs.cell_plan(get_config(arch)) == ref_specs.cell_plan(ref_get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for shape in specs.cell_plan(cfg):
        got, want = specs.input_specs(cfg, shape), ref_specs.input_specs(rcfg, shape)
        assert list(got) == list(want)
        for k, t in got.items():
            assert t.device.type == "meta", (shape, k)
            assert tuple(t.shape) == tuple(want[k].shape), (shape, k)
            assert t.dtype == _torch_dtype(want[k].dtype), (shape, k)
        assert specs.batch_logical_axes(got) == ref_specs.batch_logical_axes(want)


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("model", [1, 2, 16])
def test_cache_logical_axes_match_reference(arch, model):
    assert (specs.cache_logical_axes(get_config(arch), model)
            == ref_specs.cache_logical_axes(ref_get_config(arch), model))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_abstract_cache_matches_reference_eval_shape(arch):
    """At each cell's batch and length (bf16, the default), and once in
    f32: the same tree, shapes and dtypes, on ``meta``."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    cells = [(sh.global_batch, sh.seq_len, torch.bfloat16, jnp.bfloat16)
             for name, sh in SHAPES.items() if specs.cell_plan(cfg)[name][1] is None]
    cells.append((2, 8, torch.float32, jnp.float32))
    for b, n, dt, jdt in cells:
        got = _flat(specs.abstract_cache(cfg, b, n, dtype=dt))
        want = _flat(ref_specs.abstract_cache(rcfg, b, n, dtype=jdt))
        assert sorted(got) == sorted(want)
        for path, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[path].shape), (b, n, path)
            assert t.dtype == _torch_dtype(want[path].dtype), (b, n, path)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cache_axes_structure_matches_cache(arch):
    """cache_logical_axes mirrors Model.init_cache's tree: the same keys,
    one logical name a dim (``tests/test_sharding_rules.py``'s check)."""
    cfg = get_config(arch, smoke=True)
    cache = _flat(Model(cfg).init_cache(2, 8, device="meta"))
    axes = _flat(specs.cache_logical_axes(cfg, model_axis_size=8))
    assert sorted(cache) == sorted(axes)
    for path, t in cache.items():
        assert len(axes[path]) == t.ndim, (path, axes[path], tuple(t.shape))


def test_long_500k_skip_reason_is_the_references():
    plan = specs.cell_plan(get_config("glm4-9b"))
    assert plan["long_500k"] == ("decode", (
        "long_500k needs sub-quadratic attention; glm4-9b is pure full-attention "
        "(see DESIGN.md §Arch-applicability)"))
    assert specs.cell_plan(get_config("falcon-mamba-7b"))["long_500k"] == ("decode", None)
    assert specs.cell_plan(get_config("zamba2-2.7b"))["long_500k"] == ("decode", None)


def test_meta_stand_ins_allocate_nothing():
    """A 32k-token prefill's cache of pixtral-12b (80 GiB each of k and v
    in bf16) is built on ``meta`` with no storage behind it."""
    cache = specs.abstract_cache(get_config("pixtral-12b"), 32, 32_768)
    k = cache["layers"]["k"]
    assert k.device.type == "meta" and k.numel() * k.element_size() == 80 * 2**30
    with pytest.raises((NotImplementedError, RuntimeError)):
        k.cpu()
