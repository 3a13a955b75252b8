"""Whether ``torch.profiler`` keeps the device records of short windows after an idle spell: ``python3 tools/profiler_idle.py``.

Needs one CUDA card and ``nvcc`` (``/usr/local/cuda/bin``). Builds a
one-kernel library with the port's flags into ``build/profiler_idle/``,
then profiles windows that hold one launch of it (through ``ctypes``, as
the port's wrappers launch) with ``repro_torch.analysis.device.profile_call``
(one attempt each): six windows at once, six after ``--idle`` seconds
without profiling, and six after a second idle spell. Prints, per group,
each window's result: the number of device records besides the closing
fill, or ``X`` for a window that came back without its records. The
contract analyzer runs its profiled checks in a fresh child process
because of what this shows.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SOURCE = """__global__ void twice(float* a) { a[threadIdx.x] *= 2.0f; }
extern "C" int launch(float* a) { twice<<<1, 32>>>(a); return (int)cudaGetLastError(); }
"""


def windows(fn, n: int = 6) -> list:
    from repro_torch.analysis import AnalysisError
    from repro_torch.analysis.device import profile_call

    out = []
    for _ in range(n):
        try:
            out.append(str(len(profile_call(fn, ROOT / "build" / "profiler_idle", attempts=1))))
        except AnalysisError:
            out.append("X")
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--idle", type=float, default=35.0, help="seconds of each idle spell")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiler_idle needs a CUDA device")
    from repro_torch.kernels import build

    out_dir = ROOT / "build" / "profiler_idle"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "twice.cu").write_text(SOURCE)
    lib_path = out_dir / "libtwice.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(out_dir / "twice.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.launch.argtypes, lib.launch.restype = [ctypes.c_void_p], ctypes.c_int
    x = torch.ones(32, device="cuda")

    def launch():
        if lib.launch(x.data_ptr()) != 0:
            raise RuntimeError("launch failed")

    launch()
    torch.cuda.synchronize()
    result = {"card": torch.cuda.get_device_name(0), "first": windows(launch)}
    time.sleep(args.idle)
    result[f"after {args.idle:g} s idle"] = windows(launch)
    time.sleep(args.idle)
    result[f"after a second {args.idle:g} s idle"] = windows(launch)
    for k, v in result.items():
        print(f"{k}: {v}")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
