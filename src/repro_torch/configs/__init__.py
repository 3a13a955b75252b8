"""Architecture configs of the port: the image pipeline's and the dense LMs'."""
from repro_torch.configs.base import ModelConfig, get_config, list_archs, register

__all__ = ["ModelConfig", "get_config", "list_archs", "register"]
