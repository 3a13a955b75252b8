"""Chip smoke test of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Needs one CUDA card (an H100 is the target) and ``nvcc``. In order:

1. Prints the card's name and power limit, the torch/CUDA versions, and
   builds every kernel under ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   per source), printing the build seconds.
2. Holds K1 (``edge_cuda``) bit-equal (``torch.equal``) to its plain PyTorch
   version (``edge_plain``) on the card: magnitude, components and per-tile
   max, for every operator x variant x directions x padding at 1x1, 2x3,
   37x53 and 237x413 on gray u8, fractional gray f32, RGB u8 and
   fractional RGB f32, and for the default config at 2048x2048 f32 gray and
   1080x1920 RGB u8. The operators are the five built-ins and a 9x9
   separable one, the largest size the kernel takes.
3. Drives the facade, ``repro_torch.api.edge_detect`` with the default
   ``EdgeConfig()``, on a 1080p RGB u8 batch and an NTHW gray u8 stack; each
   must equal ``backend="torch"`` on the same device, must agree with
   digests of the JAX reference's output on small inputs, and must launch K1.
4. Serves sobel-hd at full size (2048x2048 f32 frames, 4 per request, 8
   requests) through ``repro_torch.launch.serve`` in-process, with the
   launch counts set to 0 just before and read just after; the last answer
   must equal the torch lane's on the same frames. One more request runs
   under ``torch.profiler`` and its device time by kernel is printed.
5. Times K1 with CUDA events at the server's shape and at 1080p RGB u8,
   beside its plain version, its bound on the card and a library yardstick
   (cuDNN ``F.conv2d`` of the 4-direction bank, which covers the components
   only and is used nowhere in the port), and prints one JSON line of them.

The last line is ``{"ok": true, "device": {...}}``. Any failed phase raises,
so the script exits non-zero and prints no result; so does a host without a
CUDA device, and a directory that holds this file without ``src/``.
"""
from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 33.5e12      # 67 TFLOP/s f32 counts an FMA as 2; --fmad=false runs 1 op per instruction
SIZES = ((1, 1), (2, 3), (37, 53), (237, 413))

# sha256 of the JAX reference's outputs, repro.api.edge_detect(...,
# EdgeConfig(backend="xla", with_max=True)), on the _golden_inputs() frames;
# tests/test_torch_api.py recomputes them from the reference.
GOLDEN = {
    "rgb_u8": {
        "magnitude": "662f8f004092d192fb6b2e0e5844cadf4d3a019622fb5c78449c4f2faaf83111",
        "peak": "cc6bf93c0491c86d49312035d40581af2406622fe4fe5603e3766700f1fa0051",
    },
    "gray_f32": {
        "magnitude": "a561025f16cdb60360124938a397a59059e3556d3e9c66174745e9c4cfa21f55",
        "peak": "d28b75112bbb3bfd0c5ad2b6817c0137f7e3f9e3b58778b68a20eb871d45c73c",
    },
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().numpy().astype(np.float32).tobytes()).hexdigest()


def golden_inputs():
    """Small frames from a seed; their reference digests are in GOLDEN."""
    rng = np.random.default_rng(2305)
    rgb = rng.integers(0, 256, (2, 37, 53, 3)).astype(np.uint8)
    noisy = rng.uniform(0, 255, (2, 41, 29)) + rng.normal(0, 2, (2, 41, 29))
    return {"rgb_u8": rgb, "gray_f32": np.clip(noisy, 0, 255).astype(np.float32)}


def frames(kind: str, shape, rng, device):
    if kind == "u8":
        a = rng.integers(0, 256, shape).astype(np.uint8)
    elif kind in ("f32", "rgb_f32"):
        shape = tuple(shape) + ((3,) if kind == "rgb_f32" else ())
        a = np.clip(rng.uniform(0, 255, shape) + rng.normal(0, 2, shape), 0, 255)
        a = a.astype(np.float32)
    else:
        a = rng.integers(0, 256, tuple(shape) + (3,)).astype(np.uint8)
    return torch.from_numpy(a).to(device)


def separable9():
    """A 9x9 operator (OpenCV's getDerivKernels(1, 0, ksize=9)), registered
    under ``sep9``: the largest operator size csrc/edge.cu instantiates."""
    from repro_torch.core.filters import get_operator, make_separable_spec, register_operator

    col = (1.0, 8.0, 28.0, 56.0, 70.0, 56.0, 28.0, 8.0, 1.0)
    row = (-1.0, -6.0, -14.0, -14.0, 0.0, 14.0, 14.0, 6.0, 1.0)
    register_operator("sep9", make_separable_spec("sep9", col, row), overwrite=True)
    return get_operator("sep9")


def kernel_ops_per_pixel(spec, variant: str, directions: int, rgb: bool) -> int:
    """f32 multiplies, adds and square roots K1's arithmetic needs per output
    pixel, each distinct row pass counted once (the least work of the
    ladder, not what the simple kernel recomputes). ±1 taps need no multiply."""
    def mul_add(taps):
        nz = [float(t) for t in np.ravel(taps) if t != 0.0]
        return sum(1 for t in nz if abs(t) != 1.0) + max(0, len(nz) - 1)

    from repro_torch.kernels.edge import _sym_plan

    ops = 5 if rgb else 0   # luma: 3 multiplies, 2 adds
    if variant == "direct":
        ops += sum(mul_add(k) for k in spec.bank(directions))
    else:
        (cx, rx), (cy, ry) = spec.sep_factors(0), spec.sep_factors(1)
        ops += mul_add(rx) + mul_add(cx) + mul_add(ry) + mul_add(cy)
        if directions == 4:
            if variant == "separable":
                ops += mul_add(spec.bank(4)[2]) + mul_add(spec.bank(4)[3])
            else:
                dense = [spec.kd_plus_dense()]
                if variant == "v1":
                    dense.append(spec.kd_minus_dense())
                for dm in dense:
                    passes, pass_of, _neg = _sym_plan(dm)
                    ops += sum(mul_add(p) for p in passes)
                    ops += sum(1 for p in pass_of if p >= 0) - 1
                if variant == "v2":
                    col_f, col_d, row_d = spec.v2_arrays()
                    ops += mul_add(col_f) + mul_add(row_d) + mul_add(col_d) + 1
                ops += 4    # (g+ ± g-) * 0.5
    ops += 2 * directions    # squares and their sum (directions - 1 adds) + sqrt
    return ops


def bound(n_px: int, in_bytes_px: int, out_bytes: int, ops_px: int):
    t_bytes = (n_px * in_bytes_px + out_bytes) / HBM_BYTES_PER_S
    t_ops = n_px * ops_px / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            t_bytes * 1e3, t_ops * 1e3)


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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke needs a CUDA device; torch.cuda.is_available() is False")
    from repro_torch.api import EdgeConfig, edge_detect
    from repro_torch.configs import get_config
    from repro_torch.core.filters import get_operator
    from repro_torch.data.synthetic import image_batch
    from repro_torch.kernels import build
    from repro_torch.kernels.edge import KMAX, edge_cuda, edge_plain
    from repro_torch.launch import serve

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    logs = build.build()
    print(f"build: {time.perf_counter() - t0:.1f}s for {sorted(logs) or 'cached libraries'}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {name}: {line.strip()}")

    # -- phase 2: kernel against plain --------------------------------------
    t0 = time.perf_counter()
    check(separable9().size == KMAX, f"phase 2 must cover the largest size, {KMAX}")
    rng = np.random.default_rng(0)
    cases = mismatches = 0
    for shape in SIZES:
        inputs = {k: frames(k, (2,) + shape, rng, dev) for k in ("u8", "f32", "rgb", "rgb_f32")}
        for op in ("sobel5", "sobel3", "scharr3", "prewitt3", "sobel7", "sep9"):
            spec = get_operator(op)
            for variant in spec.variants:
                for d in spec.directions:
                    for padding in ("reflect", "edge", "zero"):
                        for kind, x in inputs.items():
                            for out_components in (False, True):
                                kw = dict(spec=spec, variant=variant, directions=d,
                                          padding=padding, block_h=32, block_w=64,
                                          rgb=kind.startswith("rgb"),
                                          out_components=out_components,
                                          with_max=True)
                                a, am = edge_cuda(x, **kw)
                                b, bm = edge_plain(x, **kw)
                                cases += 1
                                if not (torch.equal(a, b) and torch.equal(am, bm)):
                                    mismatches += 1
                                    print(f"  MISMATCH {shape} {op} {variant} {d} {padding} "
                                          f"{kind} comps={out_components}: "
                                          f"{int((a != b).sum())} px, {int((am != bm).sum())} maxima")
    spec5 = get_operator("sobel5")
    full = {}
    for label, kind, shape in (("2048x2048 f32", "f32", (4, 2048, 2048)),
                               ("1080p rgb u8", "rgb", (4, 1080, 1920))):
        x = frames(kind, shape, rng, dev)
        for block in ((64, 256), (32, 128)):
            for out_components in (False, True):
                kw = dict(spec=spec5, variant="v2", directions=4, padding="reflect",
                          block_h=block[0], block_w=block[1], rgb=kind == "rgb",
                          out_components=out_components, with_max=True)
                a, am = edge_cuda(x, **kw)
                b, bm = edge_plain(x, **kw)
                cases += 1
                err = float((a - b).abs().max())
                if not (torch.equal(a, b) and torch.equal(am, bm)):
                    mismatches += 1
                    print(f"  MISMATCH {label} block={block} comps={out_components}: "
                          f"{int((a != b).sum())} px, max abs err {err}")
                if block == (64, 256) and not out_components:
                    full[label] = (x, kw, err)
        del a, am, b, bm
    torch.cuda.synchronize()
    print(f"kernel vs plain: {cases} cases, {mismatches} mismatches "
          f"({time.perf_counter() - t0:.1f}s)")
    check(mismatches == 0, f"K1 differs from edge_plain in {mismatches} of {cases} cases")

    # -- phase 3: the facade --------------------------------------------------
    for name, arr in golden_inputs().items():
        res = edge_detect(arr, EdgeConfig(with_max=True))
        for field in ("magnitude", "peak"):
            want = GOLDEN[name][field]
            got = digest(getattr(res, field))
            check(got == want, f"{name} {field} digest {got} != JAX reference {want}")
    print("facade: small inputs equal the JAX reference's digests")
    facade_inputs = {
        "1080p rgb u8 NHWC": frames("rgb", (4, 1080, 1920), rng, dev),
        "NTHW gray u8": frames("u8", (2, 3, 480, 640), rng, dev),
    }
    for label, x in facade_inputs.items():
        edge_cuda.launches = 0
        res = edge_detect(x)
        launches = edge_cuda.launches
        ref = edge_detect(x, EdgeConfig(backend="torch"))
        check(launches >= 1, f"facade on {label} did not launch K1")
        check(torch.equal(res.magnitude, ref.magnitude),
              f"facade on {label}: cuda and torch lanes differ")
        want_shape = x.shape[:-1] if res.layout.endswith("C") else x.shape
        check(res.magnitude.shape == want_shape, f"facade on {label}: shape {tuple(res.magnitude.shape)}")
        check(bool(torch.isfinite(res.magnitude).all()), f"facade on {label}: non-finite output")
        print(f"facade {label}: layout {res.layout}, K1 launches {launches}, equal to torch lane")

    # -- phase 4: the server (the main path) ---------------------------------
    edge_cuda.launches = 0
    stats = serve.main(["--arch", "sobel-hd", "--slots", "4", "--requests", "8"])
    server_launches = edge_cuda.launches
    check(server_launches >= 1, "the server did not launch K1")
    out = stats["result"]
    full_cfg = get_config("sobel-hd")
    check(tuple(out.magnitude.shape) == (4, full_cfg.image_h, full_cfg.image_w),
          f"server shape {tuple(out.magnitude.shape)}")
    check(bool(torch.isfinite(out.magnitude).all()), "server output not finite")
    # mag * RN(255 / peak) rounds twice, so the peak pixel may land one ulp
    # above 255, as it does in the JAX reference.
    top = float(np.nextafter(np.float32(255.0), np.float32(np.inf)))
    check(float(out.magnitude.max()) <= top and float(out.magnitude.min()) >= 0.0,
          f"server output outside [0, {top}]")
    check(bool((out.peak > 0).all()), "server peak not positive")
    last = torch.from_numpy(image_batch(full_cfg, 4, step=stats["requests"] - 1)["images"]).to(dev)
    server_cfg = full_cfg.edge_config(with_max=True)
    plain = edge_detect(last, server_cfg.replace(backend="torch"))
    check(torch.equal(out.magnitude, plain.magnitude) and torch.equal(out.peak, plain.peak),
          "the server's last answer differs from the torch lane on the same frames")
    print(f"server: {server_launches} K1 launches; MPS {stats['mps']:.1f}; compute "
          f"p50 {stats['compute_p50_ms']:.2f} ms p95 {stats['compute_p95_ms']:.2f} ms; "
          f"transfer p50 {stats['transfer_p50_ms']:.2f} ms p95 {stats['transfer_p95_ms']:.2f} ms; "
          "last answer equal to the torch lane")

    # One more request of the server's config under the profiler: device
    # time by kernel, to show where a request's compute goes.
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        edge_detect(last, server_cfg)
        torch.cuda.synchronize()
        span_us = (time.perf_counter() - t0) * 1e6
    kernels_run = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels_run.sort(key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in kernels_run)
    check(busy_us > 0, "the profiler saw no device time in the request")
    print(f"profile of one request: {len(kernels_run)} device kernels, busy {busy_us:.1f} us "
          f"of its {span_us:.1f} us span (host clock, under the profiler): device idle "
          f"{100 * (1 - busy_us / span_us):.1f}%")
    for e in kernels_run[:6]:
        print(f"  {e.self_device_time_total:9.1f} us  x{e.count}  {e.key[:90]}")

    # -- phase 5: timing beside the bound ------------------------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    bank = torch.from_numpy(spec5.bank(4)).to(dev)[:, None]

    def conv_components(x, rgb):
        gray = (x.float() if not rgb else
                (x[..., 0].float() * 0.299 + x[..., 1].float() * 0.587) + x[..., 2].float() * 0.114)
        xp = F.pad(gray[:, None], (2, 2, 2, 2), mode="reflect")
        return F.conv2d(xp, bank)

    timings = {}
    for label, (x, kw, err) in full.items():
        rgb = kw["rgb"]
        n_px = x.shape[0] * x.shape[1] * x.shape[2]
        gh, gw = -(-x.shape[1] // kw["block_h"]), -(-x.shape[2] // kw["block_w"])
        ms = median_ms(lambda: edge_cuda(x, **kw))
        ms_default = median_ms(lambda: edge_cuda(x, **dict(kw, block_h=32, block_w=128)))
        plain_ms = median_ms(lambda: edge_plain(x, **kw), reps=5, warm=1)
        library_ms = median_ms(lambda: conv_components(x, rgb))
        ops = kernel_ops_per_pixel(spec5, "v2", 4, rgb)
        in_bytes = 3 if rgb else x.element_size()
        b_ms, b_by, t_bytes, t_ops = bound(n_px, in_bytes, n_px * 4 + x.shape[0] * gh * gw * 4, ops)
        timings[label] = dict(ms=ms, ms_block_32x128=ms_default, plain_ms=plain_ms,
                              bound_ms=b_ms, bound_by=b_by, bytes_ms=t_bytes, ops_ms=t_ops,
                              ops_per_px=ops, library_ms=library_ms, max_abs_err=err,
                              shape=list(x.shape))
        print(f"K1 at {label} {tuple(x.shape)} block 64x256: {ms:.4f} ms (32x128: "
              f"{ms_default:.4f} ms); plain {plain_ms:.3f} ms; bound {b_ms:.4f} ms by {b_by} "
              f"(bytes {t_bytes:.4f} ms, {ops} ops/px {t_ops:.4f} ms); "
              f"cuDNN conv2d of the 4-direction bank (components only) {library_ms:.4f} ms")

    main_t = timings["2048x2048 f32"]
    kernels = [{
        "name": "K1 edge (fused Sobel megakernel)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/edge.cu",
        "replaces": "src/repro/kernels/edge.py:245",
        "launches": server_launches,
        "max_abs_err": main_t["max_abs_err"],
        "ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms"],
        "shapes": timings,
    }]
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
