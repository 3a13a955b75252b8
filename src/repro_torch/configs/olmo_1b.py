"""olmo-1b [dense] — 16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304.

Non-parametric LayerNorm (the OLMo signature). [arXiv:2402.00838; hf]
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="olmo-1b", family="dense",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=8192, vocab_size=50304, norm_type="layernorm_np", rope_theta=10_000.0,
    remat_policy="dots",
)

SMOKE = FULL.replace(
    name="olmo-1b-smoke", num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=256,
)

register("olmo-1b", FULL, SMOKE)
