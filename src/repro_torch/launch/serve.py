"""Frame-serving launcher: ``python -m repro_torch.launch.serve --arch sobel-hd``.

One request is one batch of ``--slots`` synthetic frames
(``data.synthetic.image_batch``) through :func:`repro_torch.api.edge_detect`
with the arch's ``EdgeConfig`` plus ``with_max``. One warm-up request runs
first (it also builds the CUDA kernel on first use); then every request's
host-to-device transfer and its compute are timed separately, each ended by
a device synchronise. Prints megapixels per second over the compute time
and the p50/p95 of both, as ``repro.launch.serve`` does.

Runs on the CUDA device by default; ``--device cpu`` runs the plain
PyTorch version. There is no fallback between the two.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config


def _percentile(xs, q):
    return float(np.percentile(np.asarray(xs), q))


def serve_image(cfg, args) -> dict:
    """Serve ``args.requests`` requests; returns the numbers it printed and
    the last request's :class:`~repro_torch.api.EdgeResult`."""
    from repro_torch.api import edge_detect
    from repro_torch.data.synthetic import image_batch
    from repro_torch.kernels.dispatch import resolve_backend, resolve_device

    device = resolve_device(args.device)
    edge_cfg = cfg.edge_config(with_max=True).resolved()
    backend = resolve_backend(edge_cfg.backend, device)
    print(
        f"serving {cfg.name}: operator={edge_cfg.operator} "
        f"variant={edge_cfg.variant} directions={edge_cfg.directions} "
        f"backend={backend} {cfg.image_h}x{cfg.image_w} device={device}"
    )

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def request(step):
        return torch.from_numpy(image_batch(cfg, batch=args.slots, step=step)["images"])

    edge_detect(request(0).to(device), edge_cfg, device=device)
    sync()

    lat_ms, xfer_ms = [], []
    px_total = 0
    out = None
    t_all = time.perf_counter()
    for req in range(args.requests):
        host = request(req)
        t_x = time.perf_counter()
        frames = host.to(device)
        sync()
        xfer_ms.append((time.perf_counter() - t_x) * 1e3)
        t0 = time.perf_counter()
        out = edge_detect(frames, edge_cfg, device=device)
        sync()
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        px_total += frames.shape[0] * cfg.image_h * cfg.image_w
    wall = time.perf_counter() - t_all
    if not lat_ms:
        print(f"0 requests served in {wall:.2f}s (warm-up only; "
              "use --requests >= 1 for steady-state numbers)")
        return {"requests": 0, "result": None}
    stats = {
        "requests": args.requests,
        "slots": args.slots,
        "mps": px_total / 1e6 / (sum(lat_ms) / 1e3),
        "compute_p50_ms": _percentile(lat_ms, 50),
        "compute_p95_ms": _percentile(lat_ms, 95),
        "transfer_p50_ms": _percentile(xfer_ms, 50),
        "transfer_p95_ms": _percentile(xfer_ms, 95),
        "result": out,
    }
    print(
        f"{args.requests} requests x {args.slots} frames, {wall:.2f}s -> "
        f"{stats['mps']:.1f} MPS; compute p50={stats['compute_p50_ms']:.1f}ms "
        f"p95={stats['compute_p95_ms']:.1f}ms; transfer "
        f"p50={stats['transfer_p50_ms']:.1f}ms "
        f"p95={stats['transfer_p95_ms']:.1f}ms"
    )
    return stats


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4, help="frames per request")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family != "image":
        raise SystemExit(f"arch {cfg.name!r} is family {cfg.family!r}; the port "
                         "serves image archs only")
    return serve_image(cfg, args)


if __name__ == "__main__":
    main()
