"""The port's frame server runs end to end on the CPU and serves the
reference's frames and answers: magnitude, edge maps (``--edges``) and
video streams (``--streams``)."""
import os
import subprocess
import sys
from pathlib import Path

from conftest import SUBPROCESS_TIMEOUT

import numpy as np
import pytest
import torch

from repro.api import EdgeConfig as RefConfig
from repro.api import edge_detect as ref_edge_detect
from repro.configs import get_config as ref_get_config
from repro.data.synthetic import image_batch as ref_image_batch
from repro_torch.configs import get_config
from repro_torch.data.synthetic import image_batch
from repro_torch.launch import serve

ROOT = Path(__file__).resolve().parents[1]


def test_serve_cli_smoke_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "sobel-hd", "--smoke",
         "--requests", "2", "--slots", "2", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "MPS; compute p50=" in proc.stdout and "transfer p50=" in proc.stdout
    assert "backend=torch" in proc.stdout


def test_image_batch_matches_reference():
    for smoke in (True, False):
        ref_cfg, cfg = ref_get_config("sobel-hd", smoke=smoke), get_config("sobel-hd", smoke=smoke)
        assert (cfg.image_h, cfg.image_w) == (ref_cfg.image_h, ref_cfg.image_w)
        assert (cfg.sobel_block_h, cfg.sobel_block_w) == (ref_cfg.sobel_block_h, ref_cfg.sobel_block_w)
    cfg, ref_cfg = get_config("sobel-hd", smoke=True), ref_get_config("sobel-hd", smoke=True)
    for step in (0, 3):
        np.testing.assert_array_equal(image_batch(cfg, 2, seed=1, step=step)["images"],
                                      ref_image_batch(ref_cfg, 2, seed=1, step=step)["images"])


def test_served_result_matches_reference():
    stats = serve.main(["--arch", "sobel-hd", "--smoke", "--requests", "2", "--slots", "2",
                        "--device", "cpu"])
    assert stats["requests"] == 2 and stats["mps"] > 0
    res = stats["result"]
    ref_cfg = ref_get_config("sobel-hd", smoke=True)
    frames = ref_image_batch(ref_cfg, 2, step=1)["images"]
    ref = ref_edge_detect(frames, ref_cfg.edge_config(with_max=True, backend="xla"))
    np.testing.assert_array_equal(res.magnitude.numpy(), np.asarray(ref.magnitude))
    np.testing.assert_array_equal(res.peak.numpy(), np.asarray(ref.peak))
    assert res.magnitude.dtype == torch.float32


def test_edge_config_matches_reference():
    cfg = get_config("sobel-hd").edge_config().resolved()
    ref = ref_get_config("sobel-hd").edge_config().resolved()
    for f in ("operator", "directions", "variant", "padding", "block_h", "block_w", "normalize"):
        assert getattr(cfg, f) == getattr(ref, f), f
    assert RefConfig().normalize == cfg.normalize


def test_served_edges_match_reference():
    """--edges: NMS + hysteresis through the facade; the last answer equals
    the reference's XLA lane on the same frames."""
    stats = serve.main(["--arch", "sobel-hd", "--smoke", "--requests", "2", "--slots", "2",
                        "--device", "cpu", "--edges"])
    res = stats["result"]
    ref_cfg = ref_get_config("sobel-hd", smoke=True)
    frames = ref_image_batch(ref_cfg, 2, step=1)["images"]
    ref = ref_edge_detect(frames, ref_cfg.edge_config(with_max=True, backend="xla", nms=True,
                                                       hysteresis=True))
    for field in ("magnitude", "thin", "edges", "peak"):
        np.testing.assert_array_equal(getattr(res, field).numpy(), np.asarray(getattr(ref, field)))
    assert 0.0 < stats["edge_density"] < 0.5


def _ref_stream_outputs(n_streams, n_frames, motion, decay):
    """The reference's stream path over the server's frames: per stream, the
    (magnitude, edges) of every frame."""
    from repro.api import edge_detect_stream as ref_stream
    from repro.data.synthetic import video_frame as ref_video_frame

    cfg = ref_get_config("sobel-hd", smoke=True)
    kw = dict(with_max=True, nms=True, hysteresis=True, backend="xla")
    if decay:
        kw.update(temporal=True, decay=decay)
    edge_cfg = cfg.edge_config(**kw)
    outs = {}
    for sid in range(n_streams):
        state, outs[sid] = None, []
        for t in range(n_frames):
            f = ref_video_frame(cfg, stream=sid, step=t, motion=motion)
            res, state = ref_stream(f, edge_cfg, state)
            outs[sid].append((np.asarray(res.magnitude), np.asarray(res.edges)))
    return outs


@pytest.mark.parametrize("motion,decay", ((2.0, 0.0), (0.0, 0.0), (2.0, 0.9)))
def test_served_streams_match_reference(motion, decay):
    """--streams: every served frame of every stream equals the reference's
    stream path on the same frames; the health ledger accounts for all."""
    stats = serve.main(["--arch", "sobel-hd", "--smoke", "--streams", "3", "--requests", "3",
                        "--slots", "2", "--device", "cpu", "--collect",
                        "--motion", str(motion), "--decay", str(decay)])
    health = stats["health"]
    assert health.unaccounted == 0 and health.submitted == 9 == health.counts["served"]
    assert health.retries == 0 and not health.degraded
    ref = _ref_stream_outputs(3, 3, motion, decay)
    for sid, st in stats["streams"].items():
        assert st.frames == 3 and len(st.outputs) == 3
        for t, out in enumerate(st.outputs):
            np.testing.assert_array_equal(out["magnitude"], ref[sid][t][0])
            np.testing.assert_array_equal(out["edges"], ref[sid][t][1])
        assert set(stats["per_stream"][sid]) >= {"compute_p50_ms", "compute_p99_ms",
                                                 "transfer_p50_ms", "transfer_p99_ms"}
        if motion == 0.0:
            assert st.cached_steps == 2
    if motion == 0.0:
        assert stats["skip_rate"] == 1.0


def test_serve_cli_streams_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "sobel-hd", "--smoke",
         "--streams", "2", "--requests", "3", "--decay", "0.9", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "stream 1: 3 frames" in proc.stdout and "frames/s aggregate" in proc.stdout
    assert "unaccounted=0" in proc.stdout and "backend=torch" in proc.stdout


def test_lm_server_on_cpu():
    """``--arch llama3.2-1b --smoke --device cpu``: the reference's prompts
    through the port's engine, every request served to ``--max-new``."""
    stats = serve.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                        "--requests", "6", "--slots", "3", "--max-new", "4"])
    assert len(stats["requests"]) == 6 and stats["tokens"] == 6 * 4
    assert all(len(r.output) == 4 and r.done for r in stats["requests"])
    rng = np.random.default_rng(0)     # the reference server's prompts
    prompts = []
    for _ in range(6):
        plen = int(rng.integers(2, 24))
        prompts.append(rng.integers(0, 256, plen).tolist())
    assert sorted(r.prompt for r in stats["requests"]) == sorted(prompts)
    assert stats["prefills"] == 6 and stats["decode_steps"] >= 8
    assert stats["prefill_p50_ms"] > 0 and stats["decode_p50_ms"] > 0 and stats["tok_s"] > 0
    assert stats["k4_launches"] == 0          # the CPU runs the plain lane
    assert stats["param_count"] == 102_720


@pytest.mark.parametrize("arch,params", [("qwen3-moe-30b-a3b", 157_056),
                                         ("minicpm3-4b", 107_936)])
def test_moe_and_mla_servers_on_cpu(arch, params):
    """``--arch qwen3-moe-30b-a3b|minicpm3-4b --smoke --device cpu``: the
    reference server's prompts through the port's engine (MoE routing and
    MLA's latent cache), every request served to ``--max-new``, and the
    tokens the reference's engine gives on the same weights."""
    import jax

    from repro.models import Model as RefModel
    from repro.serve import Engine as RefEngine
    from repro.serve import Request as RefRequest

    stats = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "5",
                        "--slots", "2", "--max-new", "3"])
    done = sorted(stats["requests"], key=lambda r: r.uid)
    assert len(done) == 5 and stats["tokens"] == 5 * 3 and all(r.done for r in done)
    assert stats["k4_launches"] == 0 and stats["param_count"] == params
    assert stats["prefills"] == 5 and stats["tok_s"] > 0
    # The served weights, carried back, give the reference engine's tokens.
    rcfg = ref_get_config(arch, smoke=True).replace(dtype="float32")
    rparams = jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()), stats["params"])
    assert RefModel(rcfg).param_count() == params
    eng = RefEngine(rcfg, rparams, max_batch=2, max_len=256, prompt_buckets=serve.LM_BUCKETS)
    for r in done:
        eng.submit(RefRequest(uid=r.uid, prompt=r.prompt, max_new_tokens=3))
    want = {r.uid: r.output for r in eng.run()}
    assert {r.uid: r.output for r in done} == want


def test_lm_server_cli_and_unported_archs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "olmo-1b", "--smoke",
         "--device", "cpu", "--requests", "2", "--max-new", "2"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "tok/s; prefill p50=" in proc.stdout and "K4 launches 0" in proc.stdout
    # whisper and pixtral need frontend inputs: the reference server's exit
    for argv, msg in ((["--arch", "whisper-large-v3"], "^encdec serving needs frontend "
                                                       "inputs; use examples/$"),
                      (["--arch", "pixtral-12b", "--smoke"], "^vlm serving needs frontend "
                                                             "inputs; use examples/$"),
                      (["--arch", "llama3.2-1b", "--smoke", "--streams", "2"], "--streams")):
        with pytest.raises(SystemExit, match=msg):
            serve.main(argv + ["--device", "cpu"])


def test_ssm_server_refuses_the_reference_servers_prompts():
    """``--arch falcon-mamba-7b --smoke --device cpu``: the ssm engine takes
    contexts of a bucket's exact length only, so the reference server's
    random prompt lengths are refused, in the reference's words, by the
    port's server as by the reference's."""
    import argparse

    from repro.launch.serve import serve_lm as ref_serve_lm

    with pytest.raises(ValueError, match="needs bucket-length prompts") as err:
        serve.main(["--arch", "falcon-mamba-7b", "--smoke", "--device", "cpu"])
    args = argparse.Namespace(requests=16, slots=4, max_new=16, max_len=256)
    with pytest.raises(ValueError) as ref_err:
        ref_serve_lm(ref_get_config("falcon-mamba-7b", smoke=True).replace(dtype="float32"),
                     args)
    assert str(err.value) == str(ref_err.value) == (
        "ssm engine needs bucket-length prompts; got 19, buckets=(8, 16, 32, 64)")


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_hybrid_server_refuses_the_reference_servers_prompts(smoke, monkeypatch):
    """``--arch zamba2-2.7b``: the hybrid engine, like the ssm one, takes
    contexts of a bucket's exact length only, and the port's server refuses
    the reference server's prompts in the reference's words. At FULL the
    weights are not drawn (the refusal comes from the first prompt, as
    it does on the card)."""
    import argparse

    from repro.launch.serve import serve_lm as ref_serve_lm
    from repro_torch.models import Model

    if not smoke:   # the first prefill refuses; drawing 9.7 GB here is not the point
        monkeypatch.setattr(Model, "init", lambda self, seed=0, **kw: None)
    argv = ["--arch", "zamba2-2.7b", "--device", "cpu"] + (["--smoke"] if smoke else [])
    with pytest.raises(ValueError, match="needs bucket-length prompts") as err:
        serve.main(argv)
    args = argparse.Namespace(requests=16, slots=4, max_new=16, max_len=256)
    with pytest.raises(ValueError) as ref_err:
        ref_serve_lm(ref_get_config("zamba2-2.7b", smoke=True).replace(dtype="float32"), args)
    assert str(err.value) == str(ref_err.value) == (
        "hybrid engine needs bucket-length prompts; got 19, buckets=(8, 16, 32, 64)")


@pytest.mark.parametrize("arch", ["whisper-large-v3", "pixtral-12b"])
def test_frontend_archs_exit_as_the_reference_server(arch, monkeypatch, capsys):
    """``--arch whisper-large-v3|pixtral-12b``: both servers exit with the
    same message before drawing any weights."""
    from repro.launch import serve as ref_serve

    with pytest.raises(SystemExit) as err:
        serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch, "--smoke"])
    with pytest.raises(SystemExit) as ref_err:
        ref_serve.main()
    assert str(err.value) == str(ref_err.value) == (
        f"{get_config(arch).family} serving needs frontend inputs; use examples/")


# --- The elastic, chaos-tested image server on a logical mesh of 8 CPUs -----

CPU8 = [torch.device("cpu")] * 8
SERVE = ["--arch", "sobel-hd", "--smoke", "--requests", "6", "--slots", "2"]
SHARDED_RUNS = {
    "simulate-loss": ["--shard", "2x2x2", "--simulate-loss-at", "3"],
    "chaos-loss": ["--shard", "2x2x2", "--chaos", "loss@3"],
}
REF_SERVER = r"""
import contextlib, io, itertools, json, os, sys, time, types
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
from repro.launch import serve
ticks = itertools.count()
serve.time = types.SimpleNamespace(perf_counter=lambda: next(ticks) * 1e-3, sleep=time.sleep)
out = {}
for name, argv in json.loads(sys.argv[1]).items():
    buf = io.StringIO()
    sys.argv = ["serve"] + argv
    with contextlib.redirect_stdout(buf):
        serve.main()
    out[name] = buf.getvalue()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_server_output():
    """The reference server's stdout for each of ``SHARDED_RUNS``, on 8
    forced host devices, from one subprocess."""
    import json

    runs = {k: SERVE + v for k, v in SHARDED_RUNS.items()}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", REF_SERVER, json.dumps(runs)],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=SUBPROCESS_TIMEOUT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _steady_clock(monkeypatch):
    """Give the server a clock that advances 1 ms a reading. The straggler
    monitor runs under any ``--chaos`` plan and compares each device's
    median request time with the fleet's; after a device loss the lost
    devices' times freeze, so on a loaded host a slow stretch of requests
    flags the survivors, in either package. With equal request times
    nothing is flagged, and the lines depend on the plan alone."""
    import itertools
    import time
    import types

    ticks = itertools.count()
    monkeypatch.setattr(serve, "time", types.SimpleNamespace(
        perf_counter=lambda: next(ticks) * 1e-3, sleep=time.sleep))


def _health(text):
    """The ``health:`` line's fields, as a dict, without ``backend``."""
    line = [ln for ln in text.splitlines() if ln.startswith("health: ")][-1]
    fields = {}
    for part in line[len("health: "):].split(" "):
        if "=" in part:
            k, v = part.split("=", 1)
            fields[k] = v
    fields.pop("backend")
    return fields


def _elastic_lines(text):
    keep = ("image mesh:", "device loss:", "excluding straggler")
    return [ln for ln in text.splitlines() if ln.startswith(keep)]


@pytest.mark.parametrize("run", sorted(SHARDED_RUNS))
def test_sharded_server_prints_the_reference_lines(run, reference_server_output, capsys,
                                                   monkeypatch):
    """``--shard 2x2x2`` with a device loss before request 3: the mesh,
    device-loss and ``served through reshard`` lines and every health field
    but ``backend`` equal the reference server's, both on a steady clock."""
    _steady_clock(monkeypatch)
    stats = serve.main(SERVE + SHARDED_RUNS[run] + ["--device", "cpu"], devices=CPU8)
    ours, ref = capsys.readouterr().out, reference_server_output[run]
    assert _elastic_lines(ours) == _elastic_lines(ref) == [
        "image mesh: data=2 row=2 col=2 on 8 device(s)",
        "device loss: 8 -> 4 devices; replanning mesh and resharding",
        "image mesh: data=1 row=2 col=2 on 4 device(s)",
    ]
    assert "(served through reshard)" in ours and "(served through reshard)" in ref
    assert _health(ours) == _health(ref)
    health = stats["health"]
    assert health.unaccounted == 0 and health.replans == 1 and health.backend == "torch"
    assert stats["meshes"] == [(2, 2, 2), (1, 2, 2)] and len(stats["rewarm_ms"]) == 1


def test_sharded_server_answer_equals_the_reference():
    """The last answer of a sharded ``--edges`` server equals the
    reference's single-device XLA lane on the same frames."""
    stats = serve.main(["--arch", "sobel-hd", "--smoke", "--requests", "2", "--slots", "3",
                        "--shard", "1x2x2", "--edges", "--device", "cpu"], devices=CPU8)
    res = stats["result"]
    ref_cfg = ref_get_config("sobel-hd", smoke=True)
    frames = ref_image_batch(ref_cfg, 3, step=1)["images"]
    ref = ref_edge_detect(frames, ref_cfg.edge_config(with_max=True, backend="xla", nms=True,
                                                       hysteresis=True))
    for field in ("magnitude", "thin", "edges", "peak"):
        np.testing.assert_array_equal(getattr(res, field).numpy(), np.asarray(getattr(ref, field)))
    assert stats["meshes"] == [(1, 2, 2)]


def test_chaos_server_retries_and_excludes_a_straggler(capsys, monkeypatch):
    """``fail@step:1x2;slow@d1:40``: request 0 succeeds on its third attempt,
    device 1 straggles by 40 ms a request and is excluded after three
    strikes, with the reference's "7 -> 7" replan line. On a steady clock
    the monitor sees the injected delay alone, whatever the host's load."""
    _steady_clock(monkeypatch)
    stats = serve.main(SERVE + ["--shard", "2x2x2", "--chaos", "fail@step:1x2;slow@d1:40",
                                "--device", "cpu"], devices=CPU8)
    out = capsys.readouterr().out
    health = stats["health"]
    assert (health.submitted, health.counts["served"], health.counts["retried"]) == (6, 5, 1)
    assert health.retries == 2 and health.replans == 1 and health.unaccounted == 0
    assert health.stragglers == ["d1"] and health.excluded == ["d1"]
    assert "excluding straggler d1: 7 -> 7 devices; replanning mesh and resharding" in out
    assert "image mesh: data=1 row=2 col=2 on 4 device(s)" in out
    assert "health: submitted=6 served=5 retried=1" in out


def test_persistent_failure_raises_after_the_health_line(capsys):
    """No fallback: a failure that outlasts the retries raises, after the
    ledger shows the request unaccounted."""
    from repro_torch.runtime.chaos import InjectedFault

    with pytest.raises(InjectedFault):
        serve.main(SERVE + ["--shard", "2x2x2", "--chaos", "fail@step:1x9", "--device", "cpu"],
                   devices=CPU8)
    out = capsys.readouterr().out
    assert "health: submitted=1 served=0 retried=0 degraded=0" in out
    assert "unaccounted=1" in out and "errors=1" in out


def test_unaccounted_chaos_run_exits_non_zero(monkeypatch):
    """A chaos run that leaves a request unaccounted exits non-zero."""
    from repro_torch.serve import guard

    monkeypatch.setattr(guard.Health, "record", lambda self, kind: None)
    with pytest.raises(SystemExit, match="left 6 request"):
        serve.main(SERVE + ["--chaos", "slow@d0:1", "--device", "cpu"], devices=CPU8)


def test_lm_arch_refuses_shard_and_chaos(monkeypatch):
    from repro.launch import serve as ref_serve

    for flag, value in (("--shard", "2x2x2"), ("--chaos", "loss@1")):
        argv = ["--arch", "llama3.2-1b", "--smoke", flag, value]
        with pytest.raises(SystemExit) as err:
            serve.main(argv + ["--device", "cpu"])
        monkeypatch.setattr(sys, "argv", ["serve"] + argv)
        with pytest.raises(SystemExit) as ref_err:
            ref_serve.main()
        assert str(err.value) == str(ref_err.value)
        assert str(err.value).startswith(f"{flag} applies to image (detector) serving")


def test_shard_that_does_not_fit_raises_at_startup():
    with pytest.raises(ValueError, match="spatial grid 2x2 needs 4 devices, have 1"):
        serve.main(SERVE + ["--shard", "2x2x2", "--device", "cpu"])
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        serve.main(SERVE + ["--shard", "4x2x2", "--device", "cpu"], devices=CPU8)
    with pytest.raises(ValueError, match="do not match --device"):
        serve.main(SERVE + ["--device", "cuda"], devices=CPU8)


def test_stream_server_takes_a_chaos_plan():
    stats = serve.main(["--arch", "sobel-hd", "--smoke", "--streams", "2", "--requests", "3",
                        "--device", "cpu", "--chaos", "corrupt@0:1=nan"])
    health = stats["health"]
    assert health.counts["quarantined"] == 1 and health.unaccounted == 0
