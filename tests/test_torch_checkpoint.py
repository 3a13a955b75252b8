"""The port's ``CheckpointManager`` against ``repro.checkpoint``: the
reference's atomicity, retention, resume and async tests on torch trees,
and the layout shared both ways: a checkpoint of a reference
``TrainState`` restores in the port leaf for leaf (and the port's in the
reference)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro.configs import get_config as ref_get_config
from repro.optim import adamw as radamw
from repro.train import TrainState as RefState
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.optim import adamw
from repro_torch.train import TrainConfig, Trainer, TrainState
from repro_torch.tree import leaves_with_path


def _state():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor(3.5)}}


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = _state()
    mgr.save(7, state, meta={"foo": 1})
    restored, meta = mgr.restore(state, device="cpu")
    assert torch.equal(restored["a"], state["a"]) and torch.equal(restored["b"]["c"],
                                                                 state["b"]["c"])
    assert meta["step"] == 7 and meta["meta"]["foo"] == 1
    assert sorted(os.listdir(tmp_path / "step_0000000007")) == ["arrays.npz", "meta.json"]


def test_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state())
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4
    assert CheckpointManager(str(tmp_path / "empty")).latest_step() is None


def test_no_partial_checkpoints_visible(tmp_path):
    """A leftover ``.tmp`` (a writer killed mid-save) is neither listed nor
    restored, and the next save of that step replaces it."""
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(tmp_path / "step_0000000002.tmp")
    assert mgr.all_steps() == [] and mgr.latest_step() is None
    mgr.save(2, _state())
    names = os.listdir(tmp_path)
    assert all(not n.endswith(".tmp") for n in names) and mgr.all_steps() == [2]


def test_async_save_copies_before_returning(tmp_path):
    """The host copy is taken before ``save`` returns, so the caller may go
    on changing the tensors; ``wait`` joins the writer."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    state = _state()
    mgr.save(5, state)
    state["a"].add_(100.0)
    mgr.wait()
    assert mgr.latest_step() == 5
    restored, _ = mgr.restore(_state(), device="cpu")
    assert torch.equal(restored["a"], _state()["a"])


def test_restore_checks_keys_shapes_and_places_on_the_device(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    with pytest.raises(KeyError, match="checkpoint missing 'z'"):
        mgr.restore({"z": torch.zeros(1)}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"a": torch.zeros(3, 2), "b": {"c": torch.tensor(0.0)}}, device="cpu")
    meta_t = {"a": torch.empty(2, 3, dtype=torch.float64, device="meta"),
              "b": {"c": torch.empty((), device="meta")}}
    restored, _ = mgr.restore(meta_t, device="cpu")
    assert restored["a"].dtype == torch.float64 and restored["a"].device.type == "cpu"
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "none")).restore(_state(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mgr.restore(_state())


def _ref_train_state():
    """A reference TrainState of llama3.2-1b SMOKE with non-zero moments."""
    rcfg = ref_get_config("llama3.2-1b", smoke=True)
    from repro.models import Model as RefModel

    params = RefModel(rcfg).init(jax.random.key(3))
    grads = jax.tree.map(lambda p: jnp.ones_like(p) * 0.01, params)
    p1, opt, _ = radamw.update(grads, radamw.init(params), params, jnp.float32(1e-3))
    return RefState(jnp.int32(1), p1, opt)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """Keys ``.step``, ``.params|...``, ``.opt|.count``, ``.opt|.mu|...``:
    the reference's file restores into the port's abstract state, leaf for
    leaf, bit for bit."""
    rstate = _ref_train_state()
    RefManager(str(tmp_path)).save(1, rstate, meta={"loader_state": {"step": 1, "seed": 0}})
    trainer = Trainer(get_config("llama3.2-1b", smoke=True), TrainConfig(), device="cpu")
    state, meta = CheckpointManager(str(tmp_path)).restore(trainer.abstract_state(),
                                                           device="cpu")
    assert isinstance(state, TrainState) and isinstance(state.opt, adamw.AdamWState)
    assert meta["meta"]["loader_state"] == {"step": 1, "seed": 0}
    want = dict(leaves_with_path(jax.tree.map(np.asarray, rstate)))
    got = leaves_with_path(state)
    assert sorted(p for p, _ in got) == sorted(want)
    for path, leaf in got:
        np.testing.assert_array_equal(leaf.numpy(), want[path], err_msg=str(path))
        assert leaf.dtype == (torch.int32 if path in ((".step",), (".opt", ".count"))
                              else torch.float32)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    trainer = Trainer(get_config("llama3.2-1b", smoke=True), TrainConfig(), device="cpu")
    state = trainer.init_state()
    CheckpointManager(str(tmp_path)).save(3, state)
    rstate = _ref_train_state()
    restored, meta = RefManager(str(tmp_path)).restore(jax.eval_shape(lambda: rstate))
    assert meta["step"] == 3
    got = dict(leaves_with_path(jax.tree.map(np.asarray, restored)))
    for path, leaf in leaves_with_path(state):
        np.testing.assert_array_equal(got[path], leaf.numpy(), err_msg=str(path))
