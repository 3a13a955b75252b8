"""Architecture configs of the port; this slice carries the image pipeline's."""
from repro_torch.configs.base import ModelConfig, get_config, register

__all__ = ["ModelConfig", "get_config", "register"]
