"""pixtral-12b [vlm] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.

The Pixtral-ViT frontend is a stub (the caller supplies patch embeddings,
``patch_embeds``, prepended to the text sequence); backbone = mistral-nemo style
decoder. [hf:mistralai/Pixtral-12B-2409; unverified]
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072, rope_theta=1_000_000_000.0,
    frontend="vision_stub", num_patches=1024,
)

SMOKE = FULL.replace(
    name="pixtral-12b-smoke", num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    head_dim=16, d_ff=128, vocab_size=256, num_patches=8,
)

register("pixtral-12b", FULL, SMOKE)
