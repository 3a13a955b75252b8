"""Profile K5 (``csrc/selective_scan.cu``) on the card without ``ncu``: ``python3 tools/profile_k5.py``.

Needs one CUDA card and ``nvcc``/``cuobjdump`` (``/usr/local/cuda/bin``).

1. Builds ``selective_scan.cu`` with the port's flags and prints what
   ``ptxas -v`` reports for each K5 instance (registers, shared memory,
   spills).
2. Dumps the SASS of the f32 instances with ``cuobjdump --dump-sass`` and
   prints each one's opcode counts by class (static counts: a loop body is
   counted once).
3. Times K5 at falcon-mamba-7b's shapes, f32: (1, 2048, 8192, 16) and the
   ssm engine's prefills (1, L, 8192, 16) for L = 8/16/32/64, with CUDA
   events (median of 20) and, under ``torch.profiler``, as device
   microseconds per launch (mean of 50 launches, without the host's
   launch overhead), beside the plain version's error; and with
   ``--variants`` (all, or ``--variants a,b``) scratch copies of the
   source built with one change each (``VARIANTS``, one ``nvcc`` each, all
   started together). A variant whose anchor text is absent from the source
   is reported and skipped, so the anchors of the kernel before its
   redesign stay listed beside the new ones.

Prints one JSON line of every number at the end; ``--out`` also writes it.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

from profile_k1 import card_line, compile_variant, median_ms, sass_histograms  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import selective_scan as k5  # noqa: E402

SHAPES = ((1, 2048, 8192, 16), (1, 8, 8192, 16), (1, 16, 8192, 16), (1, 32, 8192, 16),
          (1, 64, 8192, 16))
# name -> (file, [(anchor, replacement), ...]), as in profile_k1.
VARIANTS = {
    # Before the redesign (a thread per (d, n), y by warp shuffles): no
    # exp, ...
    "lane_no_exp": ("selective_scan.cu", [("const float da = expf(dtv * av);",
                                           "const float da = dtv * av;")]),
    # ... and no shuffles (y is one lane's term).
    "lane_no_shfl": ("selective_scan.cu", [(
        "for (int off = NP / 2; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);",
        "")]),
    # The redesign (a thread per channel and group of states): no exp, ...
    "no_exp": ("selective_scan.cu", [("da[i] = expf(dtv * av[i]);", "da[i] = dtv * av[i];")]),
    # ... states held in groups of 2 and of 8 instead of 4, ...
    "group_2": ("selective_scan.cu", [("#define K5_GROUP 4", "#define K5_GROUP 2")]),
    "group_8": ("selective_scan.cu", [("#define K5_GROUP 4", "#define K5_GROUP 8")]),
    # ... and chunks of 16 time steps instead of 32.
    "chunk_16": ("selective_scan.cu", [("#define K5_CHUNK 32", "#define K5_CHUNK 16")]),
}


def inputs(shape, seed: int):
    bsz, l, di, n = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(bsz, l, di, generator=g, device="cuda")
    dt = (torch.randn(bsz, l, di, generator=g, device="cuda") * 0.1).abs()
    bm = torch.randn(bsz, l, n, generator=g, device="cuda")
    cm = torch.randn(bsz, l, n, generator=g, device="cuda")
    a = -(1 + 0.3 * torch.randn(di, n, generator=g, device="cuda")).abs()
    return x, dt, bm, cm, a


def device_us(fn, launches: int = 50) -> float:
    """Mean device microseconds of K5's kernel a launch under the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
           and "selective_scan" in e.key]
    count = sum(e.count for e in evs)
    return sum(e.self_device_time_total for e in evs) / count if count else float("nan")


def time_shapes(label: str) -> dict:
    rows = {}
    for i, shape in enumerate(SHAPES):
        args = inputs(shape, seed=i)
        call = lambda: k5.selective_scan(*args, chunk=shape[1], block_d=shape[2])  # noqa: E731
        y, h = call()
        wy, wh = k5.selective_scan_plain(*args)
        row = {"ms": median_ms(call), "device_us": device_us(call),
               "y_err": float((y - wy).abs().max()), "h_err": float((h - wh).abs().max()),
               "bit_equal": bool(torch.equal(y, wy) and torch.equal(h, wh))}
        rows["x".join(map(str, shape))] = row
        print(f"{label}: K5 {shape}: {row['ms']:.4f} ms (CUDA events), {row['device_us']:.2f} us "
              f"a launch of device time; y err {row['y_err']:.3g}, h err {row['h_err']:.3g}, "
              f"bit-equal {row['bit_equal']}")
    return rows


def with_library(path: Path):
    """Point kernels.selective_scan at another build of selective_scan.cu."""
    real = build.load
    build.load = lambda name: ctypes.CDLL(str(path))
    k5._lib.cache_clear()
    try:
        k5._lib()
    finally:
        build.load = real


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="?", const="all", default=None,
                    help="also time the scratch variants (all, or a comma-separated list)")
    ap.add_argument("--out", type=Path, default=None, help="write the JSON here too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_k5 needs a CUDA device")
    card = card_line()
    print(f"card: {card}")
    logs = build.build(["selective_scan"])
    for line in logs.get("selective_scan", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    result = {"card": card, "sass": sass_histograms(
        build.library_path("selective_scan"),
        keep=lambda fn: "selective_scan" in fn and "bfloat" not in fn)}
    for fn, row in result["sass"].items():
        print(f"SASS {fn}: {json.dumps(row)}")
    result["times"] = {"as built": time_shapes("as built")}
    if args.variants:
        (ROOT / "build").mkdir(exist_ok=True)
        scratch = Path(tempfile.mkdtemp(prefix="k5_variants_", dir=ROOT / "build"))
        chosen = {k: v for k, v in VARIANTS.items()
                  if args.variants == "all" or k in args.variants.split(",")}
        with ThreadPoolExecutor(max_workers=len(chosen)) as pool:  # one nvcc each, together
            paths = dict(zip(chosen, pool.map(
                lambda kv: compile_variant(kv[0], *kv[1], scratch, source="selective_scan"),
                chosen.items())))
        for name, path in paths.items():
            if path is None:
                print(f"variant {name}: anchor not in {chosen[name][0]}; skipped")
                continue
            with_library(path)
            result["times"][name] = time_shapes(name)
        k5._lib.cache_clear()
        shutil.rmtree(scratch, ignore_errors=True)
    print(f"card: {card_line()}")
    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
