"""llama3.2-1b [dense] — 16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.

Small llama3. [hf:meta-llama/Llama-3.2-1B; unverified]
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="llama3.2-1b", family="dense",
    num_layers=16, d_model=2048, num_heads=32, num_kv_heads=8, head_dim=64,
    d_ff=8192, vocab_size=128256, rope_theta=500_000.0,
    remat_policy="dots",
)

SMOKE = FULL.replace(
    name="llama3.2-1b-smoke", num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
    head_dim=8, d_ff=128, vocab_size=256,
)

register("llama3.2-1b", FULL, SMOKE)
