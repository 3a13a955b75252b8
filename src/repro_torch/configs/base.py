"""Config schema and registry: the image-pipeline fields of ``repro.configs.base``.

``--arch <id>`` resolves through :func:`get_config`; every config has a full
form and a ``smoke`` reduction for CPU tests.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

__all__ = ["ModelConfig", "register", "get_config"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # image (the LM families are not ported yet)
    image_h: int = 0
    image_w: int = 0
    sobel_operator: str = "sobel5"   # repro_torch.core.filters registry name ("" = from sobel_size)
    sobel_size: int = 5              # operator selector when sobel_operator is ""
    sobel_directions: int = 4
    sobel_variant: str = "v2"
    sobel_backend: str = "auto"      # auto | cuda | torch
    sobel_block_h: int = 0           # CTA tile rows; 0 = default
    sobel_block_w: int = 0           # CTA tile cols; 0 = default

    def edge_config(self, **overrides):
        """This config's image pipeline as a ``repro_torch.api.EdgeConfig``."""
        from repro_torch.api import EdgeConfig
        from repro_torch.core.filters import operator_for_size

        operator = self.sobel_operator or operator_for_size(self.sobel_size)
        cfg = EdgeConfig(
            operator=operator,
            directions=self.sobel_directions,
            variant=self.sobel_variant,
            backend=self.sobel_backend,
            block_h=self.sobel_block_h or None,
            block_w=self.sobel_block_w or None,
        )
        return cfg.replace(**overrides) if overrides else cfg

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY: Dict[str, tuple] = {}

_MODULES = {
    "sobel-hd": "sobel_hd",
}


def register(arch_id: str, full: ModelConfig, smoke: ModelConfig) -> None:
    _REGISTRY[arch_id] = (full, smoke)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id not in _REGISTRY:
        mod = _MODULES.get(arch_id)
        if mod is None:
            raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
        importlib.import_module(f"repro_torch.configs.{mod}")
    full, smoke_cfg = _REGISTRY[arch_id]
    return smoke_cfg if smoke else full
