"""zamba2-2.7b [hybrid] — 54L d_model=2560 d_ff=10240 vocab=32000, Mamba-2
backbone (state=64) + ONE shared attention block (32H) applied every 6 layers.
[arXiv:2411.15242; hf]  (LoRA-per-application on the shared block is omitted;
noted in DESIGN.md.)
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000,
    ssm_type="mamba2", ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
    ssm_chunk=256, attn_every=6, sub_quadratic=True,
)

SMOKE = FULL.replace(
    name="zamba2-2.7b-smoke", num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=256, ssm_state=8, ssm_head_dim=16,
    ssm_chunk=8, attn_every=2,
)

register("zamba2-2.7b", FULL, SMOKE)
