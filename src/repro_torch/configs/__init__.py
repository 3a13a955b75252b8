"""Architecture configs of the port: the image pipeline's, the dense LMs' and
falcon-mamba-7b's (the ssm family)."""
from repro_torch.configs.base import ModelConfig, get_config, list_archs, register

__all__ = ["ModelConfig", "get_config", "list_archs", "register"]
