"""Profile K1 (``csrc/edge.cu``) on the card without ``ncu``: ``python3 tools/profile_k1.py``.

Needs one CUDA card and ``nvcc``/``cuobjdump`` (``/usr/local/cuda/bin``).

1. Builds ``edge.cu`` with the port's flags and prints what ``ptxas -v``
   reports for each K1 instance (registers, shared memory, spills).
2. Dumps the SASS of K1's sobel5 instances with ``cuobjdump --dump-sass``
   and prints, for each, the count of every opcode class that bounds a
   stencil on this card: f32 adds/multiplies, integer multiply-adds and
   adds, conversions (I2F/F2I, an eighth of the FP32 rate), shared
   and global loads, branches, and the total. Static counts: a loop body is
   counted once.
3. Times K1 with CUDA events (median of 20) at 4x2048x2048 on the FULL
   64x256 tile: the f32 lane on f32 and u8 frames, the integer lane on the
   same u8 frames, ``out_nms`` on u8, each on the instance the wrapper
   picks and (where ``edge_cuda`` has ``instance``) on the run-time-taps
   instance, and with ``--variants`` (all, or ``--variants a,b`` for some)
   scratch copies of the source built with one change each (``VARIANTS``),
   one ``nvcc`` each, all started together, on the same frames. A variant
   whose anchor text is absent from the source is reported and skipped.

Prints one JSON line of every number at the end; ``--out`` also writes it.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import inspect
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.filters import get_operator  # noqa: E402
from repro_torch.kernels import build, edge  # noqa: E402

# Scratch copies of the source, one change each: name -> (file, [(anchor,
# replacement), ...]); every occurrence of each anchor is replaced, and a
# variant any of whose anchors is absent is skipped (the anchors of an
# earlier source stay listed, so that its figures can be made again).
VARIANTS = {
    # The first version: the ladder replaced by the window's centre value,
    # what staging, the magnitude, the stores and the tile max cost.
    "stage_only": ("edge_tile.cuh", [(
        "components_f32<K, A>(taps, src, rows, g.variant, g.dirs, c);",
        "for (int d_ = 0; d_ < 4; ++d_) c[d_] = to_f32(src(K / 2, K / 2));")]),
    # The walk of the tiles without NMS left out: what staging the window,
    # the tile max and the launch cost on their own.
    "no_walk": ("edge_tile.cuh", [("      walk_column<K, A>(tp, win, ew, ex, 0, rows, e);\n", "")]),
    # The window left unstaged (the walk reads whatever shared memory
    # holds): what the walk and the stores cost on their own.
    "no_stage": ("edge_tile.cuh", [(
        "  stage_window<T, A>(g, xi, tr * g.bh - halo, tc * g.bw - halo, eh, ew, win);\n", "")]),
    # The walk's rows not unrolled on either lane (the integer lane's are
    # unrolled by K as built), and unrolled by K on both.
    "walk_unroll_1": ("edge_tile.cuh", [("#pragma unroll K\n    for (int wr = ya;",
                                         "#pragma unroll 1\n    for (int wr = ya;")]),
    "walk_unroll_K": ("edge_tile.cuh", [("#pragma unroll 1\n    for (int wr = ya;",
                                         "#pragma unroll K\n    for (int wr = ya;")]),
    # The integer lane's components converted with I2F instead of the
    # exact add-and-subtract through 1.5 * 2^23.
    "int_i2f": ("edge_tile.cuh", [(
        "  if (kSmall) return __int_as_float(x + 0x4B400000) - 12582912.0f;\n", "")]),
    # The first version's integer lane with that add-and-subtract in place
    # of its four I2F a pixel.
    "int_no_i2f": ("edge_tile.cuh", [(
        "float to_f32(int32_t x) { return __int2float_rn(x); }",
        "float to_f32(int32_t x) { return __int_as_float(x + 0x4B400000) - 12582912.0f; }")]),
    # An explicit minimum of one CTA an SM in the launch bounds.
    "min_blocks_1": ("edge.cu", [("__global__ void __launch_bounds__(MAX_THREADS)\nedge_kernel",
                                  "__global__ void __launch_bounds__(MAX_THREADS, 1)\nedge_kernel")]),
    # Twice as many staging loads in flight per thread.
    "stage_loads_16": ("edge_tile.cuh", [("#define STAGE_LOADS 8", "#define STAGE_LOADS 16")]),
}
SASS_CLASSES = {
    "f32 add/mul": ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL"),
    "int mul-add": ("IMAD", "IMUL"),
    "int add/logic": ("IADD3", "LEA", "LOP3", "SHF", "ISETP", "IMNMX", "SEL", "IABS"),
    "conversion": ("I2F", "F2I", "I2FP", "F2F", "F2IP"),
    "LDS": ("LDS",),
    "STS": ("STS",),
    "LDG": ("LDG",),
    "STG": ("STG",),
    "LDC (param/const)": ("LDC", "ULDC"),
    "branch": ("BRA", "BSSY", "BSYNC", "WARPSYNC"),
    "MUFU": ("MUFU",),
}


def median_ms(fn, reps: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def sass_histograms(lib: Path, keep=lambda fn: "edge_kernel" in fn and "ILi5E" in fn) -> dict:
    """{mangled function: {class: count, "total": n}} for the kernels ``keep``
    accepts (by default K1's K = 5 instances)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "--dump-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out, name, ops = {}, None, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name, ops = m.group(1), collections.Counter()
            if keep(name):
                out[name] = ops
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
        if m and ops is not None:
            ops[m.group(1).split(".")[0]] += 1
    hist = {}
    for fn, ops in out.items():
        row = {cls: sum(ops[o] for o in names) for cls, names in SASS_CLASSES.items()}
        row["total"] = sum(ops.values())
        row["top"] = dict(ops.most_common(12))
        hist[fn] = row
    return hist


def compile_variant(name: str, file: str, changes, scratch: Path, source: str = "edge"):
    """Build a scratch copy of csrc's ``<source>.cu`` with one change; None
    if an anchor is absent."""
    src = scratch / name
    shutil.copytree(build.CSRC, src)
    text = (src / file).read_text()
    for anchor, repl in changes:
        if anchor not in text:
            return None
        text = text.replace(anchor, repl)
    (src / file).write_text(text)
    out = scratch / f"lib{source}_{name}.so"
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, *build.NVCC_FLAGS, "-o", str(out), str(src / f"{source}.cu")],
                   check=True, capture_output=True, text=True)
    return out


def with_library(path: Path):
    """Point kernels.edge at another build of edge.cu (its entry points typed as usual)."""
    real = build.load
    build.load = lambda name: ctypes.CDLL(str(path))
    edge._lib.cache_clear()
    try:
        edge._lib("edge")
    finally:
        build.load = real


def time_lanes(label: str, inputs: dict) -> dict:
    spec = get_operator("sobel5")
    kw = dict(spec=spec, variant="v2", directions=4, padding="reflect", block_h=64, block_w=256,
              with_max=True)
    cases = {
        "f32 lane, f32 frames": (inputs["f32"], dict(kw)),
        "f32 lane, u8 frames": (inputs["u8"], dict(kw)),
        "int lane, u8 frames": (inputs["u8"], dict(kw, precision="int")),
        "out_nms, u8 frames": (inputs["u8"], dict(kw, out_nms=True)),
        "f32 lane, u8 frames, 2 directions": (inputs["u8"], dict(kw, directions=2)),
    }
    instances = ("auto", "runtime") if "instance" in inspect.signature(edge.edge_cuda).parameters \
        else ("auto",)
    rows = {}
    for case, (x, args) in cases.items():
        for inst in instances:
            kw_inst = dict(args, instance=inst) if inst != "auto" else args
            name = case if inst == "auto" else f"{case}, run-time taps"
            rows[name] = median_ms(lambda: edge.edge_cuda(x, **kw_inst))
            print(f"{label}: K1 {name}: {rows[name]:.4f} ms")
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="?", const="all", default=None,
                    help="also time the scratch variants (all, or a comma-separated list)")
    ap.add_argument("--out", type=Path, default=None, help="write the JSON here too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_k1 needs a CUDA device")
    card = card_line()
    print(f"card: {card}")
    logs = build.build(["edge"])
    for line in logs.get("edge", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    result = {"card": card, "sass": sass_histograms(build.library_path("edge"))}
    for fn, row in result["sass"].items():
        print(f"SASS {fn}: {json.dumps(row)}")
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (4, 2048, 2048)).astype(np.uint8)
    inputs = {"u8": torch.from_numpy(u8).cuda(),
              "f32": torch.from_numpy(rng.uniform(0, 255, (4, 2048, 2048)).astype(np.float32)).cuda()}
    result["times_ms"] = {"as built": time_lanes("as built", inputs)}
    if args.variants:
        (ROOT / "build").mkdir(exist_ok=True)
        scratch = Path(tempfile.mkdtemp(prefix="k1_variants_", dir=ROOT / "build"))
        chosen = {k: v for k, v in VARIANTS.items()
                  if args.variants == "all" or k in args.variants.split(",")}
        with ThreadPoolExecutor(max_workers=len(chosen)) as pool:  # one nvcc each, together
            paths = dict(zip(chosen, pool.map(
                lambda kv: compile_variant(kv[0], *kv[1], scratch), chosen.items())))
        for name, path in paths.items():
            if path is None:
                print(f"variant {name}: anchor not in {chosen[name][0]}; skipped")
                continue
            with_library(path)
            result["times_ms"][name] = time_lanes(name, inputs)
        edge._lib.cache_clear()
        shutil.rmtree(scratch, ignore_errors=True)
    print(f"card: {card_line()}")
    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
