"""Distributed edge-detection service (the paper's workload at pod scale),
the PyTorch/CUDA twin of ``examples/edge_service.py``.

Shards an image batch across the visible devices (batch -> ``data``, rows
-> ``model`` through the halo-exchange engine) and runs the fused pipeline
(kernel K1 a shard on the card) for any registered operator through one
``repro_torch.api.EdgeConfig``. On one card the mesh is 1x1; with more the
same code spans (data, model).

    PYTHONPATH=src python examples_torch/edge_service.py --batch 8 --size 512
    PYTHONPATH=src python examples_torch/edge_service.py --operator scharr3 --device cpu
"""
import argparse
import time

import torch

from repro_torch.api import EdgeConfig
from repro_torch.configs import get_config
from repro_torch.core.pipeline import make_sharded_edge_fn
from repro_torch.data.synthetic import image_batch
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.runtime.elastic import make_mesh


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--operator", default="sobel5",
                    help="registered operator name (sobel5/scharr3/sobel7/...)")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    mesh = make_mesh(None if dev.type == "cuda" else [dev], model_parallel=1)
    print(f"mesh: {dict(mesh.shape)} over {mesh.size} device(s)")
    cfg = get_config("sobel-hd").replace(image_h=args.size, image_w=args.size)
    imgs = torch.from_numpy(image_batch(cfg, args.batch)["images"]).to(mesh.lead)

    edge_cfg = EdgeConfig(operator=args.operator, normalize=False)
    edge_fn = make_sharded_edge_fn(mesh, edge_cfg, row_axis="model")
    out = edge_fn(imgs)
    _sync(out.device)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        out = edge_fn(imgs)
    _sync(out.device)
    dt = (time.perf_counter() - t0) / args.iters
    mps = args.batch * args.size**2 / 1e6 / dt
    print(f"edges {tuple(out.shape)} [{args.operator}]: {dt*1e3:.1f} ms/batch = "
          f"{mps:.1f} MPS (paper Table 2 metric)")
    return out


if __name__ == "__main__":
    main()
