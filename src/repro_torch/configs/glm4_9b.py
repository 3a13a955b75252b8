"""glm4-9b [dense] — 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.

RoPE + GQA. [hf:THUDM/glm-4-9b; hf]  (partial-rotary deviation noted in
DESIGN.md: we apply full RoPE.)
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="glm4-9b", family="dense",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=2, head_dim=128,
    d_ff=13696, vocab_size=151552, rope_theta=10_000.0,
    remat_policy="dots",
)

SMOKE = FULL.replace(
    name="glm4-9b-smoke", num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    head_dim=16, d_ff=128, vocab_size=256,
)

register("glm4-9b", FULL, SMOKE)
