"""Profile K3 (``csrc/edge_stream.cu``) on the card without ``ncu``: ``python3 tools/profile_k3.py``.

Needs one CUDA card and ``nvcc``/``cuobjdump`` (``/usr/local/cuda/bin``).

1. Builds ``edge.cu`` and ``edge_stream.cu`` with the port's flags and
   prints what ``ptxas -v`` reports for each K3 instance (registers, shared
   memory, spills).
2. Dumps the SASS of K3's compile-time sobel5 instances with ``cuobjdump
   --dump-sass`` and prints their opcode counts by class (``profile_k1``'s
   classes; static counts, a loop body counted once); the changed-tile and
   copy paths are the SASS of the ``copy_only`` and ``compute_only``
   variants below, which leave the other path out.
3. Times K3 at the stream server's shape: 4x2048x2048 u8 frames of the
   sobel-hd video (``--motion 2``, steps 6 and 7), the FULL 64x256 tile,
   NMS on, at 0%, the motion share (the change test's mask between the two
   steps) and 100% of tiles changed. For each share: CUDA-event medians of
   20 in turns with K1's NMS lane on the same frames (K1, K3, K3, K1),
   device microseconds a launch of each under ``torch.profiler`` (mean of
   50 launches), and the wrapper's host time a call (50 calls enqueued, no
   synchronisation inside), beside the bound ``chip_smoke.stream_bound``
   gives. With ``--variants`` (all, or ``--variants a,b``) scratch copies
   of the source built with one change each (``VARIANTS``, one ``nvcc``
   each, all started together) are timed the same way; a variant whose
   anchor text is absent from the source is reported and skipped.

Prints one JSON line of every number at the end; ``--out`` also writes it.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))

from chip_smoke import launch_device_us, nms_lane_ops, stream_bound  # noqa: E402
from profile_k1 import card_line, compile_variant, median_ms, sass_histograms  # noqa: E402
from repro_torch.kernels import build, edge  # noqa: E402

# name -> (file, [(anchor, replacement), ...]), as in profile_k1; the
# replacements are made in order, each at every place its anchor stands.
_WALK = "    walk_tile<K, T, P>(x, g, taps, tile, smem, warp_max, out_primary, out_bmax);\n"
_TWO_PASS_CLAIM = """// Claims items from the counter until one is work: a changed tile among
// the first ntiles items, then a band of an unchanged tile, or past the end.
__device__ __forceinline__ unsigned long long two_pass_claim(unsigned long long* claim,
                                                             const int* mask, int ntiles,
                                                             const Geom& g) {
  const long long bands = stream_copy_bands(g.bh, g.bw);
  for (;;) {
    const unsigned long long v = atomicAdd(claim, 1ull);
    if (v < (unsigned long long)ntiles) {
      if (__ldg(mask + v) != 0) return v;
    } else {
      const long long j = (long long)(v - ntiles);
      if (j >= ntiles * bands || __ldg(mask + j / bands) == 0) return v;
    }
  }
}

// Registers a thread, at most."""
VARIANTS = {
    # The changed tiles' walk left out (their items are claimed and
    # skipped), ...
    "copy_only": ("edge_stream.cu", [(_WALK, "")]),
    # ... the copy items left out, ...
    "compute_only": ("edge_stream.cu", [(
        "    copy_band(g, tile, (int)(j % bands), band_rows, vec != 0, prev_primary, prev_bmax,\n"
        "              out_primary, out_bmax);\n", "")]),
    # ... CTA b taking items b, b + grid, ... instead of claiming them, ...
    "static_stride": ("edge_stream.cu", [
        ("atomicAdd(claim, 1ull)", "(stride_next += gridDim.x) - gridDim.x"),
        ("  extern __shared__ float smem[];\n",
         "  extern __shared__ float smem[];\n  unsigned long long stride_next = blockIdx.x;\n")]),
    # ... a CTA claiming its next changed tile as it starts this one (as
    # the copies do) instead of when it has walked it, ...
    "walk_claim_ahead": ("edge_stream.cu", [
        (_WALK, "    unsigned long long ahead = 0;\n"
                "    if (threadIdx.x == 0) ahead = atomicAdd(claim, 1ull);\n" + _WALK),
        ("    if (threadIdx.x == 0) s_item[parity ^ 1] = atomicAdd(claim, 1ull);\n",
         "    if (threadIdx.x == 0) s_item[parity ^ 1] = ahead;\n")]),
    # ... no work list: two claim passes over the tiles' numbers, the first
    # skipping unchanged tiles, the second the bands of changed ones, ...
    "two_pass_claim": ("edge_stream.cu", [
        ("atomicAdd(claim, 1ull)", "two_pass_claim(claim, mask, ntiles, g)"),
        ("// Registers a thread, at most.", _TWO_PASS_CLAIM),
        ("  cur.start(true, wsum);\n", ""),
        ("  cur.start(false, wsum);\n", ""),
        ("if (!cur.seek((long long)item, wsum)) break;",
         "if (item >= (unsigned long long)ntiles) break;"),
        ("const int tile = cur.tile((long long)item, &s_rel);", "const int tile = (int)item;"),
        ("const int n_changed = cur.base + cur.count;", "const int n_changed = ntiles;"),
        ("if (!cur.seek(j / bands, wsum)) break;", "if (j >= (long long)ntiles * bands) break;"),
        ("const int tile = cur.tile(j / bands, &s_rel);", "const int tile = (int)(j / bands);")]),
    # ... no register cap (launch bounds of 384 threads: 80 registers, two
    # CTAs an SM) or a cap of 64 on the compile-time instance, ...
    "no_register_cap": ("edge_stream.cu", [("__maxnreg__(stream_max_regs<P>())",
                                            "__launch_bounds__(MAX_THREADS)")]),
    "register_cap_64": ("edge_stream.cu", [("return P::kPasses > 0 ? 72 : 80;",
                                            "return P::kPasses > 0 ? 64 : 80;")]),
    # ... the cached tiles copied a float at a time where 16-byte vectors
    # would do, ...
    "scalar_copy": ("edge_stream.cu", [("    if (vec) {", "    if (false) {")]),
    # ... 8 loads in flight a copy thread instead of 4, ...
    "copy_loads_8": ("edge_stream.cu", [("#define COPY_LOADS 4", "#define COPY_LOADS 8")]),
    # ... copy items of whole 64x256 tiles instead of 32-row bands, ...
    "copy_whole_tiles": ("edge_stream.cu", [("#define COPY_ITEM_FLOATS 8192",
                                             "#define COPY_ITEM_FLOATS 16384")]),
    # ... and the shared-memory opt-in raised only to the 64x256 NMS
    # window's 73,360 B (74 KiB) instead of all the device allows.
    "smem_optin_74k": ("edge_stream.cu", [("optin - (int)attr.sharedSizeBytes", "74 * 1024")]),
}
REPS = 50


def host_ms(fn, calls: int = REPS) -> float:
    """The wrapper's host milliseconds a call: ``calls`` calls enqueued back
    to back, the device drained before and after, not inside."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / calls


def stream_inputs() -> dict:
    """The stream server's frames of steps 6 and 7 (4 streams, motion 2),
    the caches of step 6 and the three masks."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import video_frame
    from repro_torch.kernels import dispatch

    cfg = get_config("sobel-hd")
    ecfg = cfg.edge_config(with_max=True, nms=True, hysteresis=True).resolved()

    def frames(step):
        return torch.from_numpy(np.stack([video_frame(cfg, stream=s, step=step, motion=2.0)
                                          for s in range(4)])).cuda()

    x6, x7 = frames(6), frames(7)
    _, state = dispatch.edge_stream(x6, ecfg, None, device="cuda")
    changed, _ = dispatch.stream_delta(x7, state, ecfg)
    motion = changed.to(torch.int32).contiguous()
    kw = dict(spec=ecfg.spec, variant=ecfg.variant, directions=ecfg.directions,
              padding=ecfg.padding, block_h=cfg.sobel_block_h, block_w=cfg.sobel_block_w,
              out_nms=True)
    masks = {"0%": torch.zeros_like(motion), "motion": motion, "100%": torch.ones_like(motion)}
    return dict(x=x7, prev=state.primary.contiguous(), prev_max=state.bmax.contiguous(),
                masks=masks, kw=kw)


def time_k3(label: str, inp: dict) -> dict:
    x, prev, prev_max, kw = inp["x"], inp["prev"], inp["prev_max"], inp["kw"]
    n, h, w = x.shape
    bh, bw = kw["block_h"], kw["block_w"]
    spec = kw["spec"]

    def k1():
        return edge.edge_cuda(x, with_max=True, **kw)

    k1_us = launch_device_us(k1, "edge_kernel", REPS)
    rows = {}
    for share_label, mask in inp["masks"].items():
        def k3(mask=mask):
            return edge.edge_stream_cuda(x, prev, prev_max, mask, **kw)

        got = k3()
        want = edge.edge_stream_plain(x, prev, prev_max, mask, **kw)
        equal = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
        turns = [median_ms(f) for f in (k1, k3, k3, k1)]
        m = mask.cpu().numpy()
        b_ms, b_by, _tb, _to, share = stream_bound(
            m, h, w, bh, bw, 1, nms_lane_ops(spec, "v2", 4, False, m, h, w, bh, bw))
        row = dict(k3_ms_turns=turns[1:3], k1_nms_ms_turns=[turns[0], turns[3]],
                   k3_device_us=launch_device_us(k3, "stream_kernel", REPS),
                   k1_nms_device_us=k1_us, k3_host_ms=host_ms(k3), changed_share=share,
                   bound_ms=b_ms, bound_by=b_by, bit_equal_plain=equal)
        rows[share_label] = row
        print(f"{label}: K3 at {100 * share:.2f}% changed ({share_label}): {turns[1]:.4f} / "
              f"{turns[2]:.4f} ms on CUDA events in turns with K1's NMS lane {turns[0]:.4f} / "
              f"{turns[3]:.4f} ms; device {row['k3_device_us']:.1f} us a launch (K1 NMS "
              f"{k1_us:.1f} us); host {1e3 * row['k3_host_ms']:.1f} us a call; bound "
              f"{b_ms:.4f} ms by {b_by}; bit-equal to plain: {equal}")
    return rows


def with_library(path: Path):
    """Point kernels.edge at another build of edge_stream.cu."""
    real = build.load
    build.load = lambda name: ctypes.CDLL(str(path)) if name == "edge_stream" else real(name)
    edge._lib.cache_clear()
    try:
        edge._lib("edge_stream")
        edge._lib("edge")
    finally:
        build.load = real


def k3_sass(lib: Path) -> dict:
    return sass_histograms(lib, keep=lambda fn: "stream_kernel" in fn and "Sobel5Default" in fn)


def k3_resources(lib: Path) -> dict:
    """{mangled K3 sobel5 function: "REG:.. STACK:.. SHARED:.. LOCAL:.."}
    from ``cuobjdump --dump-resource-usage``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "--dump-resource-usage", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = m.group(1)
            continue
        if name and "stream_kernel" in name and "Sobel5Default" in name and "REG:" in line:
            out[name] = " ".join(line.split())
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="?", const="all", default=None,
                    help="also time the scratch variants (all, or a comma-separated list)")
    ap.add_argument("--out", type=Path, default=None, help="write the JSON here too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_k3 needs a CUDA device")
    card = card_line()
    print(f"card: {card}")
    logs = build.build(["edge", "edge_stream"])
    for line in logs.get("edge_stream", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    lib = build.library_path("edge_stream")
    result = {"card": card, "sass": {"as built": k3_sass(lib)},
              "resources": {"as built": k3_resources(lib)}}
    for fn, row in result["sass"]["as built"].items():
        print(f"SASS {fn}: {json.dumps(row)}")
    for fn, row in result["resources"]["as built"].items():
        print(f"resources {fn}: {row}")
    inp = stream_inputs()
    result["times"] = {"as built": time_k3("as built", inp)}
    if args.variants:
        (ROOT / "build").mkdir(exist_ok=True)
        scratch = Path(tempfile.mkdtemp(prefix="k3_variants_", dir=ROOT / "build"))
        chosen = {k: v for k, v in VARIANTS.items()
                  if args.variants == "all" or k in args.variants.split(",")}
        def compile_one(kv):
            try:
                return compile_variant(kv[0], *kv[1], scratch, source="edge_stream")
            except subprocess.CalledProcessError as e:
                return e.stdout + e.stderr

        with ThreadPoolExecutor(max_workers=len(chosen)) as pool:  # one nvcc each, together
            paths = dict(zip(chosen, pool.map(compile_one, chosen.items())))
        for name, path in paths.items():
            if path is None:
                print(f"variant {name}: anchor not in {chosen[name][0]}; skipped")
                continue
            if isinstance(path, str):
                print(f"variant {name}: nvcc refused it; skipped:\n{path[-1500:]}")
                continue
            result["sass"][name] = k3_sass(path)
            result["resources"][name] = k3_resources(path)
            for fn, row in result["sass"][name].items():
                print(f"SASS {name} {fn}: {json.dumps(row)}")
            for fn, row in result["resources"][name].items():
                print(f"resources {name} {fn}: {row}")
            with_library(path)
            result["times"][name] = time_k3(name, inp)
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
