"""The port's sharding rules (``sharding/rules.py``, ``sharding/partition.py``),
ZeRO-1 axes (``optim/adamw.opt_state_axes``) and LM meshes
(``runtime/elastic.{plan_mesh,make_mesh}``, ``launch/mesh.py``) against the
reference's.

Every leaf of every registered LM arch's ``Model.logical_axes()`` at its
FULL shape, in modes ``serve``, ``train`` and ``image``, on the pod/data/
model meshes the reference's tests use: the port's spec must equal the
reference's (``logical_to_spec`` on a ``jax.sharding.AbstractMesh``) entry
for entry, a rule the mode lacks raising ``KeyError`` in both."""
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as ref_get_config
from repro.launch import mesh as ref_launch_mesh
from repro.models import Model as RefModel
from repro.optim import adamw as ref_adamw
from repro.runtime import elastic as ref_elastic
from repro.sharding import partition as ref_partition
from repro.sharding import rules as ref_rules
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import Model
from repro_torch.optim import adamw
from repro_torch.runtime.elastic import Mesh, make_image_mesh, make_mesh, plan_mesh
from repro_torch.sharding import partition, rules
from repro_torch.sharding.rules import PartitionSpec

LM_ARCHS = [a for a in list_archs() if a != "sobel-hd"]
MESHES = {"2x4x8": ((2, 4, 8), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")), "2x2": ((2, 2), ("data", "model")),
          "1x2": ((1, 2), ("data", "model")), "1x1": ((1, 1), ("data", "model"))}
CPU = torch.device("cpu")


def _meshes(name):
    shape, axes = MESHES[name]
    try:
        ref = AbstractMesh(shape, axes)
    except TypeError:  # jax<=0.4.x signature
        ref = AbstractMesh(tuple(zip(axes, shape)))
    return ref, Mesh([CPU] * int(np.prod(shape)), shape, axes)


def _walk(tree, path=()):
    """(path, leaf) of a nested dict whose leaves are tuples or shapes."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    else:
        yield path, tree


def _spec(fn):
    try:
        return tuple(fn())
    except KeyError:
        return "KeyError"


def _arch_leaves(arch):
    ref, port = RefModel(ref_get_config(arch)), Model(get_config(arch))
    r_axes, p_axes = dict(_walk(ref.logical_axes())), dict(_walk(port.logical_axes()))
    r_shapes, p_shapes = dict(_walk(ref.abstract_params())), dict(_walk(port.abstract_params()))
    assert r_axes.keys() == p_axes.keys() == r_shapes.keys() == p_shapes.keys()
    for path in r_axes:
        assert tuple(r_axes[path]) == p_axes[path], path
        assert tuple(r_shapes[path].shape) == tuple(p_shapes[path].shape), path
    return ref, port, [(path, p_axes[path], tuple(p_shapes[path].shape)) for path in p_axes]


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_logical_to_spec_equals_the_reference_on_every_leaf(arch, mesh_name):
    ref_mesh, mesh = _meshes(mesh_name)
    _ref, _port, leaves = _arch_leaves(arch)
    checked = 0
    for path, axes, shape in leaves:
        for mode in ("serve", "train", "image"):
            for with_shape in (shape, None):
                want = _spec(lambda: ref_rules.logical_to_spec(axes, ref_mesh, with_shape,
                                                               rules=mode))
                got = _spec(lambda: rules.logical_to_spec(axes, mesh, with_shape, rules=mode))
                assert got == want, (path, mode, with_shape)
                checked += 1
    assert checked == 6 * len(leaves)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_opt_state_axes_equal_the_reference(arch, mesh_name):
    ref_mesh, mesh = _meshes(mesh_name)
    ref, port, _ = _arch_leaves(arch)
    want = ref_adamw.opt_state_axes(ref.logical_axes(), ref.abstract_params(), ref_mesh)
    got = adamw.opt_state_axes(port.logical_axes(), port.abstract_params(), mesh)
    assert got.count == () and tuple(want.count) == ()
    for moments_want, moments_got in ((want.mu, got.mu), (want.nu, got.nu)):
        w, g = dict(_walk(moments_want)), dict(_walk(moments_got))
        assert w.keys() == g.keys()
        for path in w:
            assert tuple(w[path]) == g[path], path
    # and the specs the trainer places the moments by
    shapes = dict(_walk(port.abstract_params()))
    for path, axes in _walk(got.mu):
        want_spec = ref_rules.logical_to_spec(axes, ref_mesh, tuple(shapes[path].shape),
                                              rules="train")
        got_spec = rules.logical_to_spec(axes, mesh, tuple(shapes[path].shape), rules="train")
        assert tuple(got_spec) == tuple(want_spec), path


def test_specs_for_tree_and_shardings_follow_the_reference():
    ref_mesh, mesh = _meshes("4x2")
    ref, port, _ = _arch_leaves("llama3.2-1b")
    want = ref_partition.specs_for_tree(ref.logical_axes(), ref_mesh, ref.abstract_params(),
                                        rules="train")
    got = partition.specs_for_tree(port.logical_axes(), mesh, port.abstract_params(),
                                   rules="train")
    for (path, w), (path2, g) in zip(_walk(want), _walk(got)):
        assert path == path2 and tuple(w) == tuple(g), path
    sh = partition.shardings_for_tree(port.logical_axes(), mesh, rules="serve")
    assert sh["embed"]["lm_head"].mesh is mesh
    assert sh["embed"]["lm_head"].spec == PartitionSpec(None, "model")
    assert partition.replicated(mesh).spec == PartitionSpec()


@pytest.mark.parametrize("layout", ["HW", "NHW", "HWC", "NHWC", "TNHW", "NTHWC"])
def test_image_spec_equals_the_reference(layout):
    shape = tuple({"N": 4, "T": 2, "H": 64, "W": 96, "C": 3}[c] for c in layout)
    assert partition.layout_logical_axes(layout) == ref_partition.layout_logical_axes(layout)
    for dims in ((2, 2, 2), (1, 4, 2), (8, 1, 1), (1, 1, 3)):
        ref_mesh = AbstractMesh(dims, ("data", "row", "col"))
        mesh = make_image_mesh([CPU] * int(np.prod(dims)), rows=dims[1], cols=dims[2],
                               data=dims[0])
        assert tuple(mesh.shape.values()) == dims
        assert (tuple(partition.image_spec(layout, mesh, shape))
                == tuple(ref_partition.image_spec(layout, ref_mesh, shape)))
    for name in ("2x4x8", "4x2"):
        ref_mesh, mesh = _meshes(name)
        assert (tuple(partition.image_spec(layout, mesh, shape))
                == tuple(ref_partition.image_spec(layout, ref_mesh, shape)))


def test_rule_tables_are_the_references():
    assert rules.IMAGE_RULES == ref_rules.IMAGE_RULES
    assert rules.LM_RULES == ref_rules.LM_RULES
    assert rules.DEFAULT_RULES == ref_rules.DEFAULT_RULES
    assert rules.TRAIN_OVERRIDES == ref_rules.TRAIN_OVERRIDES
    for mode in ("serve", "train", "image"):
        assert rules.get_rules(mode) == ref_rules.get_rules(mode)


def test_spec_mesh_context_and_activation_shard():
    spec = PartitionSpec(("pod", "data"), None, "model")
    assert tuple(spec) == (("pod", "data"), None, "model") and len(spec) == 3
    assert spec.axes(0) == ("pod", "data") and spec.axes(1) == () and spec.axes(5) == ()
    assert spec.used() == ("pod", "data", "model") and spec == PartitionSpec(*spec)
    with pytest.raises(TypeError):
        PartitionSpec(3)
    _ref, mesh = _meshes("2x2")
    x = torch.ones(4, 6)
    assert rules.current_mesh() is None
    with rules.mesh_context(mesh, rules.get_rules("train")):
        assert rules.current_mesh() is mesh and rules.current_rules() is rules.TRAIN_RULES
        assert rules.activation_shard(x, "batch", None) is x
        with pytest.raises(KeyError):
            rules.activation_shard(x, "no_such_axis", None)
    assert rules.current_mesh() is None and rules.activation_shard(x, "no_such_axis") is x
    assert rules.sharding_for(("batch", None), mesh, (4, 6)).spec == PartitionSpec("data")


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 32])
def test_plan_and_make_mesh_equal_the_reference(n):
    for model_parallel in (1, 2, 4, 8):
        for pods in (1, 2, 4):
            kw = dict(model_parallel=model_parallel, pods=pods)
            want = ref_elastic.plan_mesh(n, **kw)
            assert plan_mesh(n, **kw) == want
            devices = [torch.device("cpu")] * n
            mesh = make_mesh(devices, **kw)
            assert mesh.axis_names == want[1] and tuple(mesh.shape.values()) == want[0]
            assert mesh.size == int(np.prod(want[0])) == len(list(mesh.positions()))
    mesh = make_mesh([torch.device("cpu")] * 8, model_parallel=2)
    assert mesh.shape == {"data": 4, "model": 2}
    assert list(mesh.positions())[:3] == [(0, 0), (0, 1), (1, 0)]


def test_make_mesh_places_the_devices_in_order_and_defaults_to_cuda():
    devices = [torch.device("cpu")] * 8
    mesh = make_mesh(devices, model_parallel=2, pods=2)
    assert mesh.shape == {"pod": 2, "data": 2, "model": 2} and mesh.lead == devices[0]
    assert all(mesh.device(p) == torch.device("cpu") for p in mesh.positions())
    with pytest.raises(ValueError):
        Mesh(devices[:3], (2, 2), ("data", "model"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(model_parallel=2)


def test_make_production_mesh_on_device_lists():
    assert launch_mesh.MESH_SHAPES == ref_launch_mesh.MESH_SHAPES
    cpu = torch.device("cpu")
    single = launch_mesh.make_production_mesh([cpu] * 256)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    multi = launch_mesh.make_production_mesh([cpu] * 600, multi_pod=True)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.size == 512
    with pytest.raises(RuntimeError, match=r"need 256 devices for mesh \(16, 16\), have 8"):
        launch_mesh.make_production_mesh([cpu] * 8)
    with pytest.raises(RuntimeError, match="XLA_FLAGS"):
        ref_launch_mesh.make_production_mesh()      # the reference's own message
