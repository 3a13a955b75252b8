"""Where the two attention lanes of FULL whisper-large-v3 and pixtral-12b part: ``python3 tools/encdec_lane_divergence.py``.

Needs one CUDA card (about 55 GB free) and ``nvcc``. Draws whisper-large-v3
and then pixtral-12b at FULL width and depth in f32 from seed 0, as
``chip_smoke.py`` phases 14-15 do, on ``chip_smoke.frontend_batch``'s
inputs (4 prompts: whisper's 32 tokens over the 1,500-frame window,
pixtral's 1,024 patches + 32 tokens), and prints, stack by stack and
layer by layer (the encoder's, then the decoder's):

- the deviation of the first block's attention scores (q.k / sqrt(D),
  first prompt, every head), which sets how sharp the softmax is;
- forced: the block's self-attention on both lanes (K4 and the plain
  attention) from the plain lane's hidden state, the difference relative
  to its largest value;
- free-running: the K4 lane on its own hidden state against the plain
  lane, and the control, the plain lane on inputs moved by one ulp (x (1 +
  2^-23): the frontend embeddings and the token embeddings), relative to
  the plain lane's largest value;

then the last position's logits of both free-running runs against the
plain lane's. Shows why ``chip_smoke.py`` holds these families block by
block (``frontend_layer_local``) and end to end only where the control
stays within ``LOGIT_TOL``. ~1 min after the build.
"""
from __future__ import annotations

import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

ARCHS = (cs.ENCDEC_ARCH, cs.VLM_ARCH)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def stack(cfg, layers, xs: dict, pos, causal: bool, label: str, enc=None) -> dict:
    """Run ``layers`` on each lane's hidden state (``xs``: auto, torch,
    control), printing the forced and free-running differences."""
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import _gqa_qkv, apply_attention, cross_kv
    from repro_torch.models.layers import apply_norm

    for i in range(layers["attn"]["wq"].shape[0]):
        lp = T._layer(layers, i)
        xn = apply_norm(lp["ln1"], cfg, xs["torch"])
        h = {bk: apply_attention(lp["attn"], cfg, xn, pos, causal=causal, backend=bk)[0]
             for bk in ("auto", "torch")}
        if i == 0:
            q, k, _ = _gqa_qkv(lp["attn"], cfg, xn, pos)
            k = k.repeat_interleave(q.shape[2] // k.shape[2], dim=2)    # GQA: KV heads
            scores = torch.einsum("shd,thd->hst", q[0], k[0]) / math.sqrt(q.shape[-1])
            print(f"{label} layer 0 attention scores: deviation {float(scores.std()):.3g}, "
                  f"largest {float(scores.abs().max()):.3g}")
        for lane in xs:
            backend = "auto" if lane == "auto" else "torch"
            enc_kv = None if enc is None else cross_kv(lp["cross"], cfg, enc[lane])
            xs[lane], _, _ = T._apply_attn_block(lp, cfg, xs[lane], pos, causal=causal,
                                                 enc_kv=enc_kv, backend=backend)
        print(f"{label} layer {i:2d}: forced attention {rel(h['auto'], h['torch']):.3g}; "
              f"free-running K4 lane {rel(xs['auto'], xs['torch']):.3g}, one-ulp control "
              f"{rel(xs['control'], xs['torch']):.3g}")
    return xs


def run(arch: str, dev) -> None:
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import apply_norm

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = cs.draw(arch, None, dev)
    batch = cs.frontend_batch(cfg, dev)
    inputs = {"auto": (params, batch), "torch": (params, batch),
              "control": (cs.ulp_params(params), cs.ulp_batch(batch))}
    enc = None
    with torch.no_grad():
        if cfg.family == "encdec":
            x0 = batch["enc_embeds"]
            b, t = x0.shape[0], x0.shape[1]
            pos = torch.arange(t, dtype=torch.int32, device=dev)[None].expand(b, t)
            sin = T._sinusoid(pos, cfg.d_model)
            xs = {lane: bt["enc_embeds"] + sin for lane, (_, bt) in inputs.items()}
            xs = stack(cfg, params["encoder"]["layers"], xs, pos, False, "encoder")
            enc = {lane: apply_norm(params["encoder"]["final_norm"], cfg, x)
                   for lane, x in xs.items()}
        xs, pos = {}, None
        for lane, (w, bt) in inputs.items():
            xs[lane], pos = T._prepare_inputs(w, cfg, bt, torch.float32)
        xs = stack(cfg, params["layers"], xs, pos, True, "decoder", enc)
        logits = {lane: T.unembed(params, cfg, apply_norm(params["final_norm"], cfg,
                                                          x[:, -1:]))
                  for lane, x in xs.items()}
    print(f"{cfg.name} last-position logits: K4 lane apart by "
          f"{float((logits['auto'] - logits['torch']).abs().max()):.3g}, the one-ulp control "
          f"by {float((logits['control'] - logits['torch']).abs().max()):.3g} (largest logit "
          f"{float(logits['torch'].abs().max()):.3g})")
    del params, inputs, xs, enc, logits
    cs.free_weights()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("encdec_lane_divergence needs a CUDA device")
    dev = torch.device("cuda")
    print(f"card: {cs.card_line()}")
    for arch in ARCHS:
        run(arch, dev)
    print(f"card: {cs.card_line()}")


if __name__ == "__main__":
    main()
