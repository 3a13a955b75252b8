"""The port's frame server runs end to end on the CPU and serves the
reference's frames and answers."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
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
