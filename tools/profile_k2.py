"""Profile K2 (``csrc/edge_pipelined.cu``) on the card without ``ncu``: ``python3 tools/profile_k2.py``.

Needs one CUDA card and ``nvcc``/``cuobjdump`` (``/usr/local/cuda/bin``).

1. Builds ``edge_pipelined.cu`` with the port's flags and prints what
   ``ptxas -v`` reports for each K2 instance (registers, shared memory,
   spills).
2. Dumps the SASS of K2's K = 5 instances with ``cuobjdump --dump-sass``
   and prints each one's opcode counts by class (``profile_k1``'s classes;
   static counts, a loop body counted once).
3. Times K2 in turns with K1 (K1, K2, K2, K1; CUDA-event medians of 20)
   at 4x2048x2048 on the FULL 64x256 tile: the f32 lane on f32 frames (and
   on a copy of them off 16 bytes, K2's cp.async route), the f32 and
   integer lanes on u8 frames, at every ring depth whose footprint
   fits, and with ``--variants`` (all, or ``--variants a,b``) scratch
   copies of the source built with one change each (``VARIANTS``, one
   ``nvcc`` each, all started together) on the same frames. A variant whose
   anchor text is absent from the source is reported and skipped, so the
   anchors of the kernel before its redesign stay listed beside the new
   ones.

Prints one JSON line of every number at the end; ``--out`` also writes it.
"""
from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import shutil
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

from profile_k1 import card_line, compile_variant, median_ms, sass_histograms  # noqa: E402
from repro_torch.core.filters import get_operator  # noqa: E402
from repro_torch.kernels import build, edge  # noqa: E402

# name -> (file, [(anchor, replacement), ...]), as in profile_k1.
VARIANTS = {
    # Before the redesign (one CTA per tile row, strips through a sink):
    # the ladder replaced by the strip's centre value, ...
    "strip_no_ladder": ("edge_pipelined.cu", [(
        "components_f32<K, A>(taps, src, rows, g.variant, g.dirs, c);",
        "for (int d_ = 0; d_ < 4; ++d_) c[d_] = to_f32(src(K / 2, K / 2));")]),
    # ... the row-pass sink left unfilled, ...
    "strip_no_sink": ("edge_pipelined.cu", [("      if (L.n_sink) {\n", "      if (false) {\n")]),
    # ... and no window copied (the ring holds whatever it held).
    "strip_no_copy": ("edge_pipelined.cu", [("    if (jw < g.gw) {\n", "    if (false) {\n")]),
    # The redesign (the CTA refills the ring as it goes, converts each slot
    # into K1's window and walks it): the walk left out, ...
    "no_walk": ("edge_pipelined.cu", [("    float tmax = walk_tile<K, A>(",
                                       "    float tmax = 0.0f;\n    if (false) walk_tile<K, A>(")]),
    # ... the conversion from the slot left out (the walk reads whatever
    # the window holds), ...
    "no_convert": ("edge_pipelined.cu", [("    convert_window<T, A>(", "    if (false) convert_window<T, A>(")]),
    # ... no copy issued (each slot is only signalled full), ...
    "no_copy": ("edge_pipelined.cu", [("#define K2_COPY 1", "#define K2_COPY 0")]),
    # ... and one band of threads a tile instead of up to 512 threads.
    "one_band": ("edge_pipelined.cu", [("  int b = k2_consumers(size) / tile_threads(bw, nms);",
                                        "  int b = 1;")]),
}


def _depths(x: torch.Tensor) -> list:
    spec = get_operator("sobel5")
    return [d for d in edge.PIPELINE_DEPTHS
            if edge.pipelined_smem_bytes(64, 256, spec.radius, d, x.element_size(), 1, False)
            <= edge.SMEM_MAX]


def time_k2(label: str, inputs: dict) -> dict:
    """K2 at each fitting depth, in turns with K1 on the same call."""
    spec = get_operator("sobel5")
    kw = dict(spec=spec, variant="v2", directions=4, padding="reflect", block_h=64, block_w=256,
              with_max=True)
    k2_inst = "instance" in inspect.signature(edge.edge_pipelined_cuda).parameters
    cases = {
        "f32 lane, f32 frames": (inputs["f32"], dict(kw)),
        "f32 lane, f32 frames off 16 bytes (cp.async)": (inputs["f32@1"], dict(kw)),
        "f32 lane, u8 frames": (inputs["u8"], dict(kw)),
        "int lane, u8 frames": (inputs["u8"], dict(kw, precision="int")),
    }
    rows = {}
    for case, (x, args) in cases.items():
        for depth in _depths(x):
            insts = ("auto", "runtime") if k2_inst else ("auto",)
            for inst in insts:
                k2_args = dict(args, pipeline_depth=depth)
                k1_args = dict(args)
                if inst != "auto":
                    k2_args["instance"] = k1_args["instance"] = inst
                a = median_ms(lambda: edge.edge_cuda(x, **k1_args))
                b = median_ms(lambda: edge.edge_cuda(x, **k2_args))
                c = median_ms(lambda: edge.edge_cuda(x, **k2_args))
                d = median_ms(lambda: edge.edge_cuda(x, **k1_args))
                name = f"{case}, depth {depth}" + ("" if inst == "auto" else ", run-time taps")
                rows[name] = {"k2_ms": [b, c], "k1_ms": [a, d]}
                print(f"{label}: {name}: K2 {b:.4f} / {c:.4f} ms, K1 {a:.4f} / {d:.4f} ms")
    routes = {k: getattr(edge.edge_pipelined_cuda, k) for k in ("tma_launches", "cp_async_launches")
              if hasattr(edge.edge_pipelined_cuda, k)}
    if routes:
        print(f"{label}: K2 copy routes so far {routes}")
    return rows


def with_library(path: Path):
    """Point kernels.edge at another build of edge_pipelined.cu."""
    real = build.load
    build.load = lambda name: ctypes.CDLL(str(path)) if name == "edge_pipelined" else real(name)
    edge._lib.cache_clear()
    try:
        edge._lib("edge_pipelined")
        edge._lib("edge")
    finally:
        build.load = real


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="?", const="all", default=None,
                    help="also time the scratch variants (all, or a comma-separated list)")
    ap.add_argument("--out", type=Path, default=None, help="write the JSON here too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_k2 needs a CUDA device")
    card = card_line()
    print(f"card: {card}")
    logs = build.build(["edge", "edge_pipelined"])
    for line in logs.get("edge_pipelined", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    result = {"card": card, "sass": sass_histograms(
        build.library_path("edge_pipelined"),
        keep=lambda fn: "pipelined_kernel" in fn and "ILi5E" in fn)}
    for fn, row in result["sass"].items():
        print(f"SASS {fn}: {json.dumps(row)}")
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (4, 2048, 2048)).astype(np.uint8)
    inputs = {"u8": torch.from_numpy(u8).cuda(),
              "f32": torch.from_numpy(rng.uniform(0, 255, (4, 2048, 2048)).astype(np.float32)).cuda()}
    # The same f32 frames one element past a 16-byte boundary: K2's cp.async route.
    flat = torch.empty(inputs["f32"].numel() + 1, device="cuda")
    inputs["f32@1"] = flat[1:].view(inputs["f32"].shape)
    inputs["f32@1"].copy_(inputs["f32"])
    result["times_ms"] = {"as built": time_k2("as built", inputs)}
    if args.variants:
        (ROOT / "build").mkdir(exist_ok=True)
        scratch = Path(tempfile.mkdtemp(prefix="k2_variants_", dir=ROOT / "build"))
        chosen = {k: v for k, v in VARIANTS.items()
                  if args.variants == "all" or k in args.variants.split(",")}
        with ThreadPoolExecutor(max_workers=len(chosen)) as pool:  # one nvcc each, together
            paths = dict(zip(chosen, pool.map(
                lambda kv: compile_variant(kv[0], *kv[1], scratch, source="edge_pipelined"),
                chosen.items())))
        for name, path in paths.items():
            if path is None:
                print(f"variant {name}: anchor not in {chosen[name][0]}; skipped")
                continue
            with_library(path)
            result["times_ms"][name] = time_k2(name, inputs)
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
