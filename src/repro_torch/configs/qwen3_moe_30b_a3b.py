"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) d_ff=768/expert
vocab=151936, MoE 128 experts top-8, QK-norm. [hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4, head_dim=128,
    d_ff=768, vocab_size=151936, qk_norm=True, rope_theta=1_000_000.0,
    num_experts=128, num_experts_per_tok=8, moe_group_size=4096,
)

SMOKE = FULL.replace(
    name="qwen3-moe-30b-a3b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=32, vocab_size=256,
    num_experts=8, num_experts_per_tok=2, moe_group_size=32,
)

register("qwen3-moe-30b-a3b", FULL, SMOKE)
