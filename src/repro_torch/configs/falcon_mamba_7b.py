"""falcon-mamba-7b [ssm] — 64L d_model=4096 (attn-free) vocab=65024, state=16.

Pure Mamba-1 architecture. [arXiv:2410.05355; unverified]
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, vocab_size=65024, attn_type="none",
    ssm_type="mamba1", ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_chunk=16,
    # ssm_chunk=16: §Perf hillclimb — XLA assoc-scan traffic scales ~log2(chunk);
    # 256->16 cut the train_4k memory term 1.8x (EXPERIMENTS.md).
    sub_quadratic=True,
)

SMOKE = FULL.replace(
    name="falcon-mamba-7b-smoke", num_layers=2, d_model=64, vocab_size=256,
    ssm_state=4, ssm_chunk=8, ssm_dt_rank=8,
)

register("falcon-mamba-7b", FULL, SMOKE)
