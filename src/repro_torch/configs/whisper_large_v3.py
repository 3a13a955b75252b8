"""whisper-large-v3 [audio] — 32L(enc)+32L(dec) d_model=1280 20H d_ff=5120
vocab=51866. Enc-dec; the conv frontend is a stub (the caller supplies
precomputed frame embeddings, ``enc_embeds``). [arXiv:2212.04356]

Deviation (DESIGN.md): sinusoidal positions on both stacks (whisper's decoder
uses learned positions capped at 448; the reference's decode shapes need 32k+).
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="whisper-large-v3", family="encdec",
    num_layers=32, encoder_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
    head_dim=64, d_ff=5120, vocab_size=51866, is_encoder_decoder=True,
    use_rope=False, norm_type="layernorm", mlp_type="gelu",
    frontend="audio_stub", encoder_len=1500,
    remat_policy="dots",  # the reference's remat, on one device and on a mesh
)

SMOKE = FULL.replace(
    name="whisper-large-v3-smoke", num_layers=2, encoder_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256, encoder_len=16,
)

register("whisper-large-v3", FULL, SMOKE)
