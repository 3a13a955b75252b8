"""Quickstart: multi-directional edge detection through the repro_torch.api
facade, the PyTorch/CUDA twin of ``examples/quickstart.py``.

One entry point, one frozen config, one structured result: runs the paper's
four-directional 5x5 RG-v2 pipeline, swaps in other registered operators
(Scharr / Prewitt / extended 7x7 Sobel), compares the kernel-variant ladder,
and cross-checks the fused CUDA kernel (K1) against the plain PyTorch lane
(``backend="torch"``) on the same device, bit for bit. On the CPU
(``--device cpu``) both calls run the plain lane.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.api import EdgeConfig, edge_detect
from repro_torch.configs import get_config
from repro_torch.core.filters import SobelParams, list_operators
from repro_torch.core.ssim import ssim
from repro_torch.data.synthetic import image_batch
from repro_torch.kernels.dispatch import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("sobel-hd", smoke=True).replace(image_h=256, image_w=256)
    images = torch.from_numpy(image_batch(cfg, batch=2)["images"]).to(dev)
    print(f"input batch: {tuple(images.shape)} {str(images.dtype).replace('torch.', '')}")

    # --- the three-liner ---
    result = edge_detect(images, EdgeConfig(operator="sobel5"), device=dev)
    print(f"edges: {tuple(result.magnitude.shape)}, layout={result.layout}, "
          f"max={float(result.magnitude.max()):.1f}")

    # --- structured outputs: components, orientation, per-image peak ---
    rich = edge_detect(images, EdgeConfig(with_components=True, with_orientation=True,
                                          with_max=True), device=dev)
    print(f"components: {tuple(rich.components.shape)}, "
          f"orientation in [{float(rich.orientation.min()):.2f}, "
          f"{float(rich.orientation.max()):.2f}] rad, peaks={rich.peak.cpu().numpy()}")

    # --- the whole operator registry through the same call ---
    for op in list_operators():
        out = edge_detect(images, EdgeConfig(operator=op, normalize=False), device=dev)
        print(f"operator {op:10s}: resolved variant={out.config.variant}, "
              f"directions={out.config.directions}, "
              f"mean={float(out.magnitude.mean()):.1f}")

    # --- variant ladder agreement (paper Fig. 7 check) ---
    ref = edge_detect(images, EdgeConfig(variant="direct", normalize=False), device=dev)
    for variant in ("separable", "v1", "v2"):
        out = edge_detect(images, EdgeConfig(variant=variant, normalize=False), device=dev)
        s = float(torch.mean(ssim(out.magnitude, ref.magnitude)))
        print(f"variant {variant:10s}: SSIM vs naive = {s:.6f}")

    # --- fused CUDA kernel K1 against the plain lane on the same device ---
    kern = edge_detect(images, EdgeConfig(normalize=False, block_h=64), device=dev)
    plain = edge_detect(images, EdgeConfig(normalize=False, block_h=64, backend="torch"),
                        device=dev)
    lane = float(torch.max(torch.abs(kern.magnitude - plain.magnitude)))
    err = float(torch.max(torch.abs(kern.magnitude - ref.magnitude)))
    print(f"kernel max |err| vs torch lane: {lane:.2e} "
          f"({'bit-equal' if torch.equal(kern.magnitude, plain.magnitude) else 'NOT bit-equal'})")
    print(f"kernel max |err| vs naive reference: {err:.2e}")

    # --- generalized weights (paper §3.2) ---
    custom = edge_detect(images, EdgeConfig(params=SobelParams(a=1, b=3, m=8, n=4)), device=dev)
    print(f"custom-weight edges: max={float(custom.magnitude.max()):.1f}")


if __name__ == "__main__":
    main()
