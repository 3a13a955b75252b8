"""The port's ``Trainer`` (``train/loop.py``) and ``launch/train.py``
against ``repro.train``: the loss history from the same carried weights
and data, microbatches, the injected-failure restart and the failure
budget, checkpoint resume, the launcher's lines, and the card lane's K4
launches a step (a stand-in ``_launch``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data import DataLoader as RefLoader
from repro.optim import adamw as radamw
from repro.train import TrainConfig as RefTrainConfig
from repro.train import Trainer as RefTrainer
from repro.train import TrainState as RefState
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.loader import DataLoader
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import train as launch_train
from repro_torch.models import Model, carry_params
from repro_torch.models import attention as A
from repro_torch.models import remat
from repro_torch.runtime import FaultPolicy, StepFailure
from repro_torch.train import TrainConfig, Trainer, TrainState
from repro_torch.train import loop as train_loop
from repro_torch.tree import leaves, leaves_with_path

ARCH = "llama3.2-1b"
KW = dict(batch=4, seq_len=16, steps=6, peak_lr=5e-3, warmup_steps=2, log_every=1)
# f32 losses. The first three are the loss at the initial weights (step 0's
# lr is 0) and after one AdamW update: equal to the reference's but for the
# order of f32 sums (observed <= 2e-6). After that Adam's early updates
# (m / sqrt(v), sign-like while v is small) turn the two libraries' f32
# gradient differences (~2e-4 of a leaf's largest gradient: the random
# weights' sharp attention amplifies last-bit differences, PERF.md §6) into
# whole steps of lr: observed 7.0e-3 by the sixth step at lr 5e-3.
EARLY_TOL, LATE_TOL = 1e-5, 2e-2
# The two-microbatch step's pre-clip gradient norm: the same gradients in
# another f32 summation order (observed 5.5e-5 relative).
NORM_RTOL = 5e-4


def _cfgs(dtype="float32"):
    return (ref_get_config(ARCH, smoke=True).replace(dtype=dtype),
            get_config(ARCH, smoke=True).replace(dtype=dtype))


def _weights(cfg):
    """The port's seed-1 weights as numpy (the reference's initializer
    salts each leaf with the process's hash)."""
    return jax.tree.map(lambda t: t.numpy(), Model(cfg).init(1, device="cpu"))


def _ref_fit(rcfg, np_params, tc_kw, **fit_kw):
    tr = RefTrainer(rcfg, RefTrainConfig(**tc_kw))
    tr.init_state = lambda: RefState(jnp.int32(0), jax.tree.map(jnp.asarray, np_params),
                                     radamw.init(jax.tree.map(jnp.asarray, np_params)))
    return tr.fit(RefLoader(rcfg, tc_kw["batch"], tc_kw["seq_len"], seed=0), **fit_kw)


def test_loss_history_matches_the_reference_trainer():
    rcfg, cfg = _cfgs()
    np_params = _weights(cfg)
    want = _ref_fit(rcfg, np_params, KW)
    tr = Trainer(cfg, TrainConfig(**KW), device="cpu")
    got = tr.fit(DataLoader(cfg, KW["batch"], KW["seq_len"], seed=0, device="cpu"),
                 params=carry_params(np_params, cfg, device="cpu"))
    assert got["step"] == want["step"] == list(range(1, 7)) and got["restarts"] == 0
    np.testing.assert_allclose(got["loss"][:3], want["loss"][:3], rtol=0, atol=EARLY_TOL)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=LATE_TOL)
    assert got["lr"][0] == 0.0 and all(g > 0 for g in got["grad_norm"])
    assert isinstance(tr.state, TrainState) and int(tr.state.step) == 6
    assert tr.monitor.history and len(tr.monitor.history) == 6


def _captured_grads(monkeypatch, trainer, state, batch):
    seen = {}
    real = train_loop.adamw.update

    def capture(grads, *args, **kw):
        seen["grads"] = grads
        return real(grads, *args, **kw)

    monkeypatch.setattr(train_loop.adamw, "update", capture)
    _new, metrics = trainer.step_fn(state, batch)
    monkeypatch.undo()
    return seen["grads"], metrics


def test_microbatches_accumulate_to_the_full_batch(monkeypatch):
    """Two microbatches of 2 rows: the mean of their gradients (summed in
    f32) is the 4-row batch's gradient, and the metrics are their mean;
    the grad norm is the reference's two-microbatch step's."""
    rcfg, cfg = _cfgs()
    np_params = _weights(cfg)
    loader = DataLoader(cfg, 4, 16, seed=0, device="cpu")
    batch = next(loader)
    loader.close()
    one = Trainer(cfg, TrainConfig(**KW), device="cpu")
    two = Trainer(cfg, TrainConfig(**dict(KW, microbatches=2)), device="cpu")
    state = one.init_state(carry_params(np_params, cfg, device="cpu"))
    g1, m1 = _captured_grads(monkeypatch, one, state, batch)
    g2, m2 = _captured_grads(monkeypatch, two, state, batch)
    for (path, a), b in zip(leaves_with_path(g2), leaves(g1)):
        scale = float(b.abs().max().clamp_min(1e-30))
        assert float((a - b).abs().max()) <= 1e-5 * scale, path
    assert abs(float(m2["loss"]) - float(m1["loss"])) <= 1e-6
    rtr = RefTrainer(rcfg, RefTrainConfig(**dict(KW, microbatches=2)))
    rp = jax.tree.map(jnp.asarray, np_params)
    _rs, rm = rtr.step_fn(RefState(jnp.int32(0), rp, radamw.init(rp)),
                          {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    np.testing.assert_allclose(float(m2["grad_norm"]), float(rm["grad_norm"]), rtol=NORM_RTOL)
    np.testing.assert_allclose(float(m2["loss"]), float(rm["loss"]), rtol=0, atol=1e-6)


def test_train_restart_after_injected_failure(tmp_path):
    """The reference's test (``tests/test_checkpoint_fault.py``): three
    failures at step 8 outlast one retry, so the trainer restores step 5's
    checkpoint and replays; the last checkpoint is step 14 and restores to
    the final state bit for bit."""
    cfg = get_config(ARCH, smoke=True)
    tc = TrainConfig(batch=4, seq_len=16, steps=14, peak_lr=5e-3, warmup_steps=2,
                     checkpoint_every=5, log_every=2)
    tr = Trainer(cfg, tc, device="cpu")
    loader = DataLoader(cfg, tc.batch, tc.seq_len, seed=0, device="cpu")
    mgr = CheckpointManager(str(tmp_path), keep=2)
    fails = {"n": 0}

    def inject(step):
        if step == 8 and fails["n"] < 3:
            fails["n"] += 1
            raise StepFailure("injected")

    hist = tr.fit(loader, manager=mgr, fail_injector=inject,
                  policy=FaultPolicy(max_retries_per_step=1, max_total_failures=8))
    assert hist["restarts"] >= 1 and fails["n"] == 3
    assert np.isfinite(hist["loss"]).all()
    assert hist["loss"][-1] < hist["loss"][0] + 0.5
    assert mgr.latest_step() == 14 and mgr.all_steps() == [10, 14]
    restored, meta = mgr.restore(tr.abstract_state(), device="cpu")
    assert meta["meta"]["loader_state"] == {"step": 14, "seed": 0}
    for (path, a), b in zip(leaves_with_path(restored), leaves(tr.state)):
        assert torch.equal(a, b), path


def test_failure_budget_exhaustion_and_no_manager():
    cfg = get_config(ARCH, smoke=True)
    tc = TrainConfig(batch=2, seq_len=8, steps=3)

    def always(_step):
        raise StepFailure("always")

    with pytest.raises(RuntimeError, match="failure budget exhausted"):
        Trainer(cfg, tc, device="cpu").fit(
            DataLoader(cfg, 2, 8, device="cpu"), fail_injector=always,
            policy=FaultPolicy(max_retries_per_step=5, max_total_failures=2))
    with pytest.raises(StepFailure):
        Trainer(cfg, tc, device="cpu").fit(
            DataLoader(cfg, 2, 8, device="cpu"), fail_injector=always,
            policy=FaultPolicy(max_retries_per_step=1, max_total_failures=8))


def test_resume_from_checkpoint_continues_the_same_run(tmp_path):
    """Six steps, a new trainer resumes from the step-6 checkpoint with the
    loader's state and runs to 10: its losses are the uninterrupted run's,
    bit for bit (the state, the data and the arithmetic are the same)."""
    cfg = get_config(ARCH, smoke=True).replace(dtype="float32")
    tc = TrainConfig(batch=2, seq_len=8, steps=10, warmup_steps=2, checkpoint_every=6,
                     log_every=1)
    whole = Trainer(cfg, tc, device="cpu").fit(DataLoader(cfg, 2, 8, device="cpu"))
    mgr = CheckpointManager(str(tmp_path))
    Trainer(cfg, tc, device="cpu").fit(DataLoader(cfg, 2, 8, device="cpu"), steps=6,
                                       manager=mgr)
    assert mgr.all_steps() == [6]
    resumed = Trainer(cfg, tc, device="cpu").fit(DataLoader(cfg, 2, 8, device="cpu"),
                                                 manager=mgr)
    assert resumed["step"] == [7, 8, 9, 10] and mgr.latest_step() == 10
    assert resumed["loss"] == whole["loss"][6:]


def test_card_lane_launches_k4_once_a_layer_a_microbatch(monkeypatch):
    """On the card lane (``models.attention`` told so; K4's ``_launch`` a
    counting plain version) a step launches K4 once a layer a microbatch in
    its forward, and once more in the backward where the config
    rematerialises (``remat.forward_runs``), and trains: every parameter
    moves by step 2."""
    def k4(q, k, v, causal):
        FA.flash_attention.launches += 1
        with torch.no_grad():
            return FA.flash_attention_plain(q, k, v, causal=causal)

    monkeypatch.setattr(FA, "_launch", k4)
    monkeypatch.setattr(A, "resolve_backend", lambda backend, device: "cuda")
    cfg = get_config(ARCH, smoke=True)
    tc = TrainConfig(batch=4, seq_len=16, steps=3, microbatches=2, warmup_steps=1,
                     peak_lr=1e-3, log_every=1)
    tr = Trainer(cfg, tc, device="cpu")
    init = tr.init_state()
    before = FA.flash_attention.launches
    hist = tr.fit(DataLoader(cfg, 4, 16, device="cpu"), params=init.params)
    assert FA.flash_attention.launches - before == 3 * cfg.num_layers * 2 * remat.forward_runs(
        cfg)
    assert np.isfinite(hist["loss"]).all() and hist["lr"][0] == 0.0
    for (path, a), b in zip(leaves_with_path(tr.state.params), leaves(init.params)):
        assert not torch.equal(a, b), path


def test_launcher_prints_the_reference_lines(tmp_path, capsys):
    out = launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "4",
                             "--batch", "2", "--seq", "8", "--ckpt", str(tmp_path)])
    text = capsys.readouterr().out
    assert "arch=llama3.2-1b-smoke devices=1" in text
    assert f"params={Model(get_config(ARCH, smoke=True)).param_count():,}" in text
    assert "done: loss" in text and "restarts=0, stragglers=[]" in text
    assert out["history"]["step"] == [1, 2, 3, 4] and out["trainer"].state is not None
    assert CheckpointManager(str(tmp_path)).latest_step() == 4


def test_launcher_refuses_a_mesh_and_defaults_to_cuda(capsys):
    """A mesh request over one device is the reference's one-device run (a
    1x1 mesh); over 4 devices every family takes the mesh (the hybrid
    here); with no ``--device`` the launcher and the trainer want CUDA."""
    out = launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "1",
                             "--batch", "2", "--seq", "8", "--model-parallel", "2",
                             "--pods", "2"])
    assert "devices=1 mesh={'data': 1, 'model': 1}" in capsys.readouterr().out
    assert out["trainer"].mesh is None and out["mesh"].size == 1
    out = launch_train.main(["--arch", "zamba2-2.7b", "--smoke", "--device", "cpu", "--steps",
                             "1", "--batch", "2", "--seq", "8", "--model-parallel", "2"],
                            devices=[torch.device("cpu")] * 4)
    assert out["trainer"].mesh is out["mesh"] and out["mesh"].shape == {"data": 2, "model": 2}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_train.main(["--arch", ARCH, "--smoke", "--steps", "1"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(get_config(ARCH, smoke=True), TrainConfig())
