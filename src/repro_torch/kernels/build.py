"""Builds the port's CUDA sources with ``nvcc`` and loads them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/repro_torch/lib<name>-<digest>.so`` at the root of the checkout, at
first use; the sources share ``csrc/*.cuh`` headers. The digest covers every
file under ``csrc/`` and the flags, so an edited source or header is rebuilt
and an unchanged one is loaded as it is. The sources compile in parallel,
each in its own thread's ``nvcc``. No source includes PyTorch's headers,
which keeps a build to a minute or two rather than many minutes.

Flags: ``sm_90a`` (Hopper), ``-O3`` and ``--fmad=false``: the kernels must
round every product and sum on its own to stay bit-identical to their plain
PyTorch versions. No ``--use_fast_math``: ``sqrtf`` and division stay IEEE.
The library embeds the ``compute_90a`` PTX it was assembled from beside
the ``sm_90a`` cubin (the card runs the cubin): the contract analyzer
reads the PTX back (``cuobjdump --dump-ptx``) to check that no product was
contracted, at no extra compile.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build", "load", "library_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=[sm_90a,compute_90a]",
    "-O3", "--fmad=false", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 900

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); the "
            "CUDA kernels are built from source at first use"
        )
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def _compile(name: str):
    """One ``nvcc`` for ``csrc/<name>.cu``: ``(name, ok, log)``, the log
    ending in the compile's seconds."""
    out = library_path(name)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              timeout=BUILD_TIMEOUT_S)
        ok, log = proc.returncode == 0, proc.stdout
    except subprocess.TimeoutExpired as e:
        ok, log = False, f"nvcc timed out after {BUILD_TIMEOUT_S}s\n{e.output or ''}"
    if not ok:
        tmp.unlink(missing_ok=True)
        return name, False, log
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return name, True, f"{log}\nnvcc {name}.cu: {time.perf_counter() - t0:.1f}s"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named sources (default: every ``csrc/*.cu``) that are not
    built yet: one ``nvcc`` each, all started together.

    Returns ``{name: compiler output}`` for the sources compiled by this
    call (``-Xptxas -v`` reports registers, shared memory and spills),
    each ending in a line with the source's compile seconds.
    Raises ``RuntimeError`` with the compiler's output when a build fails.
    """
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    todo = [name for name in names if not library_path(name).exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with ThreadPoolExecutor(max_workers=len(todo)) as pool:
            results = list(pool.map(_compile, todo))
    else:
        results = []
    logs, failed = {}, []
    for name, ok, log in results:
        if ok:
            logs[name] = log
        else:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
