"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=6400/expert
vocab=32064, MoE 16 experts top-2. [hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=6400, vocab_size=32064, norm_type="layernorm", rope_theta=10_000.0,
    num_experts=16, num_experts_per_tok=2, moe_group_size=4096,
)

SMOKE = FULL.replace(
    name="phi3.5-moe-42b-a6.6b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=32, vocab_size=256,
    num_experts=4, num_experts_per_tok=2, moe_group_size=32,
)

register("phi3.5-moe-42b-a6.6b", FULL, SMOKE)
