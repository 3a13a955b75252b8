"""minicpm3-4b [dense] — 62L d_model=2560 40H d_ff=6400 vocab=73448, MLA.

Multi-head latent attention (DeepSeek-V2 style): q_lora=768, kv_lora=256,
qk_nope=64, qk_rope=32, v=64. [hf:openbmb/MiniCPM3-4B; hf]
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="minicpm3-4b", family="dense",
    num_layers=62, d_model=2560, num_heads=40, num_kv_heads=40, head_dim=96,
    d_ff=6400, vocab_size=73448, attn_type="mla",
    q_lora_rank=768, kv_lora_rank=256, qk_rope_head_dim=32, qk_nope_head_dim=64,
    v_head_dim=64, rope_theta=10_000.0,
)

SMOKE = FULL.replace(
    name="minicpm3-4b-smoke", num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    head_dim=24, d_ff=128, vocab_size=256,
    q_lora_rank=32, kv_lora_rank=16, qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16,
)

register("minicpm3-4b", FULL, SMOKE)
