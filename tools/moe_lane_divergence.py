"""Where the two attention lanes of a FULL-width MoE model part: ``python3 tools/moe_lane_divergence.py``.

Needs one CUDA card (about 63 GB free) and ``nvcc``. Draws qwen3-moe-30b-a3b
(24 of 48 layers) and then phi3.5-moe-42b-a6.6b (8 of 32 layers) at FULL
width in f32 from seed 0, as ``chip_smoke.py`` phases 11-11c do, and for
one prompt of 16 random tokens and one of 2,048 prints, layer by layer:

- forced: each block on both lanes (K4 and the plain attention) from the
  plain lane's hidden state: the attention output's difference relative to
  its largest value, the router logits' largest difference, the block
  output's relative difference, how many tokens chose other experts and the
  plain lane's least margin between its k-th and (k+1)-th router logit;
- free-running: the K4 lane on its own hidden state against the plain lane
  (relative block difference, router-logit difference, tokens routed
  apart), and the same for the control, the plain lane from embeddings
  moved by one ulp (x (1 + 2^-23));

then the last position's logits of both free-running runs against the
plain lane's. Shows why ``chip_smoke.py`` compares a moe model's lanes
layer by layer (``layer_local``): at random weights the gates carry a
last-bit difference from layer to layer, so the free-running lanes part
about as far as the plain lane parts from itself. ~1 min after the build.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

RUNS = (("qwen3-moe-30b-a3b", 24), ("phi3.5-moe-42b-a6.6b", 8))
LENGTHS = (16, 2048)


def block(lp, cfg, x, pos, backend):
    """One block on one lane; returns (output, (router logits, experts))."""
    from repro_torch.models import transformer as T
    from repro_torch.models.moe import record_routing

    with record_routing() as log:
        y, _, _ = T._apply_attn_block(lp, cfg, x, pos, causal=True, backend=backend)
    return y, log[0][:2]


def parted(a, b) -> torch.Tensor:
    return (a.sort(dim=-1).values != b.sort(dim=-1).values).any(dim=-1)


def run(arch: str, layers: int, dev) -> None:
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import apply_attention
    from repro_torch.models.layers import apply_norm

    cfg, params = cs.draw(arch, layers, dev)
    k = cfg.num_experts_per_tok
    rng = np.random.default_rng(7)
    for n in LENGTHS:
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n)).astype(np.int32)).to(dev)
        x0, pos = T._prepare_inputs(params, cfg, {"tokens": tokens}, torch.float32)
        xp, xk, xc = x0, x0, x0 * (1 + 2.0 ** -23)
        print(f"--- {arch}, {layers} layers, {n} tokens", flush=True)
        for i in range(cfg.num_layers):
            lp = T._layer(params["layers"], i)
            yp, (lg_p, ip) = block(lp, cfg, xp, pos, "torch")
            yt, (lg_t, it) = block(lp, cfg, xp, pos, "auto")
            xn = apply_norm(lp["ln1"], cfg, xp)
            a = {b: apply_attention(lp["attn"], cfg, xn, pos, backend=b)[0]
                 for b in ("torch", "auto")}
            top = torch.topk(lg_p, k + 1, dim=-1).values
            margin = top[:, k - 1] - top[:, k]
            yk, (lg_k, ik) = block(lp, cfg, xk, pos, "auto")
            yc, (lg_c, ic) = block(lp, cfg, xc, pos, "torch")
            print(f"L{i:2d} |x| {float(yp.abs().max()):9.3g} router std {float(lg_p.std()):6.3g}"
                  f" | forced: attention {cs.max_rel(a['auto'], a['torch']):.2e}, router "
                  f"{float((lg_t - lg_p).abs().max()):.2e}, block {cs.max_rel(yt, yp):.2e}, "
                  f"parted {int(parted(ip, it).sum())}, least margin {float(margin.min()):.2e}"
                  f" | free: K4 {cs.max_rel(yk, yp):.2e}, router "
                  f"{float((lg_k - lg_p).abs().max()):.2e}, parted {int(parted(ip, ik).sum())};"
                  f" control {cs.max_rel(yc, yp):.2e}, router "
                  f"{float((lg_c - lg_p).abs().max()):.2e}, parted {int(parted(ip, ic).sum())}",
                  flush=True)
            xp, xk, xc = yp, yk, yc

        def logits(x):
            return T.unembed(params, cfg, apply_norm(params["final_norm"], cfg, x[:, -1:]))

        want = logits(xp)
        print(f"last logits: K4 lane {float((logits(xk) - want).abs().max()):.3g}, control "
              f"{float((logits(xc) - want).abs().max()):.3g}, largest "
              f"{float(want.abs().max()):.3g}", flush=True)
    del params
    cs.free_weights()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("moe_lane_divergence needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"card: {cs.card_line()}", flush=True)
    t0 = time.perf_counter()
    for arch, layers in RUNS:
        run(arch, layers, dev)
    print(f"moe_lane_divergence: {time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    main()
