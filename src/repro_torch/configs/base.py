"""Config schema and registry: the fields of ``repro.configs.base`` that the
port runs, with the reference's names and defaults: the image pipeline's,
the dense LM's (with MLA), the MoE's, the SSM's (Mamba-1 and Mamba-2), the
hybrid's shared attention, the encoder-decoder's and the modality frontend
stubs'.

``--arch <id>`` resolves through :func:`get_config`; every config has a full
form and a ``smoke`` reduction for CPU tests. ``remat`` and
``remat_policy`` are the reference's and take effect in every training
forward (``models/remat.py``); the reference's ``scan_layers`` has no
counterpart, since the port's layer stack is an eager loop. ``SHAPES`` is
the reference's LM shape set, the cells of the dry run
(``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ARCH_IDS", "register", "get_config",
           "list_archs"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm | image
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # --- attention ---
    attn_type: str = "gqa"           # gqa | mla | none
    rope_theta: float = 10_000.0
    use_rope: bool = True
    qk_norm: bool = False
    attn_logit_softcap: float = 0.0
    # MLA (DeepSeek/MiniCPM3-style latent attention)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0

    # --- norm / mlp ---
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm | layernorm_np
    mlp_type: str = "swiglu"         # swiglu | gelu
    norm_eps: float = 1e-5

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 4096       # routing group (tokens); GShard-style
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3

    # --- SSM ---
    ssm_type: str = "none"           # none | mamba1 | mamba2
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64           # mamba2
    ssm_dt_rank: int = 0             # mamba1 (0 -> ceil(d_model/16))
    ssm_chunk: int = 128             # scan/SSD chunk length (a shape gate of kernel K5)
    ssm_scan_dtype: str = "float32"  # scan element dtype: float32 | bfloat16 (f32 carry)

    # --- hybrid (zamba-style shared attention) ---
    attn_every: int = 0              # 0 = no shared block

    # --- encoder-decoder ---
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_len: int = 1500          # stub frontend frames at serve time

    # --- modality frontend stubs (precomputed embeddings) ---
    frontend: str = "none"           # none | audio_stub | vision_stub
    num_patches: int = 0             # vision_stub: patches prepended to text

    # --- image pipeline (sobel-hd: the paper's own workload) ---
    image_h: int = 0
    image_w: int = 0
    sobel_operator: str = "sobel5"   # repro_torch.core.filters registry name ("" = from sobel_size)
    sobel_size: int = 5              # operator selector when sobel_operator is ""
    sobel_directions: int = 4
    sobel_variant: str = "v2"
    sobel_backend: str = "auto"      # auto | cuda | torch
    sobel_block_h: int = 0           # CTA tile rows; 0 = default
    sobel_block_w: int = 0           # CTA tile cols; 0 = default
    sobel_shard: str = ""            # image-mesh shard spec "DxRxC" | "auto"; "" = single device

    def edge_config(self, **overrides):
        """This config's image pipeline as a ``repro_torch.api.EdgeConfig``."""
        from repro_torch.api import EdgeConfig, ShardConfig
        from repro_torch.core.filters import operator_for_size

        operator = self.sobel_operator or operator_for_size(self.sobel_size)
        cfg = EdgeConfig(
            operator=operator,
            directions=self.sobel_directions,
            variant=self.sobel_variant,
            backend=self.sobel_backend,
            block_h=self.sobel_block_h or None,
            block_w=self.sobel_block_w or None,
            shard=ShardConfig.parse(self.sobel_shard) if self.sobel_shard else None,
        )
        return cfg.replace(**overrides) if overrides else cfg

    # --- runtime ---
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "minimal"    # minimal (save the units' inputs) | dots | none
    sub_quadratic: bool = False      # True for SSM/hybrid: long_500k runnable

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.ssm_type == "mamba1" and self.ssm_dt_rank == 0:
            object.__setattr__(self, "ssm_dt_rank", -(-self.d_model // 16))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# The LM shape set (the same for every LM arch).
SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

_REGISTRY: Dict[str, tuple] = {}

ARCH_IDS = (
    "zamba2-2.7b",
    "whisper-large-v3",
    "pixtral-12b",
    "qwen3-moe-30b-a3b",
    "phi3.5-moe-42b-a6.6b",
    "falcon-mamba-7b",
    "glm4-9b",
    "olmo-1b",
    "minicpm3-4b",
    "llama3.2-1b",
    "sobel-hd",                      # the paper's own workload, as an arch
)

_MODULES = {
    "zamba2-2.7b": "zamba2_2_7b",
    "whisper-large-v3": "whisper_large_v3",
    "pixtral-12b": "pixtral_12b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b_a6_6b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "glm4-9b": "glm4_9b",
    "olmo-1b": "olmo_1b",
    "minicpm3-4b": "minicpm3_4b",
    "llama3.2-1b": "llama3_2_1b",
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


def list_archs() -> Tuple[str, ...]:
    return ARCH_IDS
