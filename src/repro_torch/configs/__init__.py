"""Architecture configs of the port: the image pipeline's, the dense LMs'
(minicpm3-4b with multi-head latent attention), the MoE LMs' (qwen3-moe-30b-a3b,
phi3.5-moe-42b-a6.6b), falcon-mamba-7b's (the ssm family), zamba2-2.7b's
(hybrid), whisper-large-v3's (encoder-decoder) and pixtral-12b's (VLM)."""
from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    get_config,
    list_archs,
    register,
)

__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "ShapeConfig", "get_config", "list_archs",
           "register"]
