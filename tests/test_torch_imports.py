"""The port stands alone: neither ``jax`` nor the ``repro`` package is
imported by ``src/repro_torch``, ``chip_smoke.py`` or the twins of the
examples (``examples_torch/``)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_gpu.py"] + sorted(
    (ROOT / "examples_torch").glob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_repro(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_leaves_jax_out():
    code = (
        "import sys; import repro_torch.api, repro_torch.launch.serve, "
        "repro_torch.kernels.build, repro_torch.configs.sobel_hd, repro_torch.core.nms, "
        "repro_torch.serve.streams, repro_torch.serve.guard, repro_torch.runtime, "
        "repro_torch.data.synthetic, repro_torch.core.ladder, repro_torch.kernels.tuning, "
        "repro_torch.kernels.flash_attention, repro_torch.models, repro_torch.models.layers, "
        "repro_torch.models.attention, repro_torch.models.transformer, "
        "repro_torch.serve.engine, repro_torch.configs.llama3_2_1b, "
        "repro_torch.configs.olmo_1b, repro_torch.configs.glm4_9b, "
        "repro_torch.kernels.selective_scan, repro_torch.models.ssm, "
        "repro_torch.configs.falcon_mamba_7b, repro_torch.analysis, repro_torch.analysis.device, "
        "repro_torch.analysis.__main__, repro_torch.core.ssim, repro_torch.kernels.ref, "
        "repro_torch.tree, repro_torch.optim, repro_torch.optim.adamw, "
        "repro_torch.optim.schedule, repro_torch.data.loader, repro_torch.checkpoint, "
        "repro_torch.checkpoint.manager, repro_torch.train, repro_torch.train.loop, "
        "repro_torch.launch.train, repro_torch.launch.mesh, repro_torch.sharding.rules, "
        "repro_torch.sharding.partition, repro_torch.sharding.placed, "
        "repro_torch.optim.compress, repro_torch.serve.paged, repro_torch.launch.specs, "
        "repro_torch.launch.dryrun, repro_torch.roofline, repro_torch.roofline.constants, "
        "repro_torch.roofline.analysis, repro_torch.models.remat; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
