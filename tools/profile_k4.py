"""Profile K4 (``csrc/flash_attention.cu``) on the card without ``ncu``: ``python3 tools/profile_k4.py``.

Needs one CUDA card and ``nvcc``/``cuobjdump`` (``/usr/local/cuda/bin``).

1. Builds ``flash_attention.cu`` with the port's flags and prints what
   ``ptxas -v`` reports (registers, spills) for each instance.
2. Dumps the SASS of the f32 instances with ``cuobjdump --dump-sass`` and
   prints each one's opcode counts (static: a loop body is counted once).
3. Times K4 with CUDA events (median of 20) at (1, 32, 2048, 64) causal
   f32, beside ``F.scaled_dot_product_attention`` on the same inputs (the
   yardstick; the port never calls it), and scratch copies of the source
   built with one change each (``VARIANTS``), each checked against the
   plain version where the change keeps the function.

Prints one JSON line of every number at the end; ``--out`` also writes it.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

# name -> (anchor, replacement, keeps the function): one change each.
VARIANTS = {
    # One TF32 product instead of three: what the split's two extra mma cost.
    "1xtf32": ("""#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < active) mma(c[i], a.small, bb[i][0], bb[i][1]);
  if (!kExactB) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < active) mma(c[i], a.big, bs[i][0], bs[i][1]);
  }
""", "", False),
    # The small parts fed to the tensor cores unrounded (they truncate them).
    "small_unrounded": ("  small = tf32(x - __uint_as_float(big));",
                        "  small = __float_as_uint(x - __uint_as_float(big));", True),
    # At most 170 registers, so that three CTAs can share an SM.
    "3_ctas_per_sm": ("__launch_bounds__(THREADS)\nflash_kernel",
                      "__launch_bounds__(THREADS, 3)\nflash_kernel", True),
    # No exp in the softmax: what the accurate expf costs.
    "no_exp": ("s[j][i] = expf(s[j][i] - base[i >> 1]);", "s[j][i] = s[j][i] - base[i >> 1];",
               False),
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


def sass_histograms(lib: Path) -> dict:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "--dump-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out, ops = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            ops = collections.Counter()
            if "flash_kernel" in m.group(1) and "Ef" in m.group(1):
                out[m.group(1)] = ops
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
        if m and ops is not None:
            ops[m.group(1).split(".")[0]] += 1
    return {fn: dict(total=sum(c.values()), top=dict(c.most_common(16))) for fn, c in out.items()}


def variant_library(name: str, anchor: str, repl: str, scratch: Path):
    src = scratch / name
    shutil.copytree(build.CSRC, src)
    text = (src / "flash_attention.cu").read_text()
    if anchor not in text:
        return None
    (src / "flash_attention.cu").write_text(text.replace(anchor, repl))
    out = scratch / f"libflash_{name}.so"
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, *build.NVCC_FLAGS, "-o", str(out), str(src / "flash_attention.cu")],
                   check=True, capture_output=True, text=True)
    return out


def use_library(path: Path) -> None:
    real = build.load
    build.load = lambda name: ctypes.CDLL(str(path))
    fa._lib.cache_clear()
    try:
        fa._lib()
    finally:
        build.load = real


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None, help="write the JSON here too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_k4 needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    logs = build.build(["flash_attention"])
    for line in logs.get("flash_attention", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    result = {"card": card, "sass": sass_histograms(build.library_path("flash_attention"))}
    for fn, row in result["sass"].items():
        print(f"SASS {fn}: {json.dumps(row)}")
    g = torch.Generator(device="cuda").manual_seed(2048)
    q, k, v = (torch.randn((1, 32, 2048, 64), generator=g, device="cuda") for _ in range(3))
    want = fa.flash_attention_plain(q, k, v)

    def run():
        return fa.flash_attention(q, k, v, block_q=2048, block_kv=2048)

    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)  # noqa: E731
    times = {"sdpa": median_ms(sdpa), "as built": median_ms(run)}
    errs = {"as built": float((run() - want).abs().max())}
    scratch = Path(tempfile.mkdtemp(prefix="k4_variants_", dir=ROOT / "build"))
    for name, (anchor, repl, keeps) in VARIANTS.items():
        path = variant_library(name, anchor, repl, scratch)
        if path is None:
            print(f"variant {name}: anchor absent; skipped")
            continue
        use_library(path)
        times[name] = median_ms(run)
        if keeps:
            errs[name] = float((run() - want).abs().max())
    fa._lib.cache_clear()
    shutil.rmtree(scratch, ignore_errors=True)
    times["sdpa again"] = median_ms(sdpa)
    for name, ms in times.items():
        print(f"K4 (1, 32, 2048, 64) causal f32, {name}: {ms:.4f} ms"
              + (f", max abs err {errs[name]:.3g}" if name in errs else ""))
    result.update(times_ms=times, max_abs_err=errs)
    print(f"card: {card_line()}")
    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
