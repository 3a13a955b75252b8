"""sobel-hd [image] — the paper's own workload: batched four-directional
5x5 Sobel edge detection (RG-v2) on 2048x2048 frames.

``FULL`` pins the 64 x 256 output tile of the reference deployment; the
smoke config (64x64 frames) leaves the tile to the default.
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="sobel-hd", family="image",
    image_h=2048, image_w=2048,
    sobel_operator="sobel5", sobel_directions=4, sobel_variant="v2",
    sobel_backend="auto", sobel_block_h=64, sobel_block_w=256,
)

SMOKE = FULL.replace(
    name="sobel-hd-smoke", image_h=64, image_w=64,
    sobel_block_h=0, sobel_block_w=0,
)

register("sobel-hd", FULL, SMOKE)
