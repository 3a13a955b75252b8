"""Long-context decode with an attention-free SSM: O(1) state per token,
the PyTorch/CUDA twin of ``examples/long_context.py``.

The ``long_500k`` shape is runnable only for sub-quadratic archs
(falcon-mamba, zamba2). This demo decodes a (smoke-scale) falcon-mamba
model far past any attention window and shows that the per-token cost and
the state size stay constant. The decode step is plain PyTorch on either
device, as the reference's is XLA: it launches no kernel (K5 is the
prefill's scan).

    PYTHONPATH=src python examples_torch/long_context.py --tokens 512 [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import Model
from repro_torch.tree import leaves


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tokens", type=int, default=512)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("falcon-mamba-7b", smoke=True).replace(dtype="float32")
    model = Model(cfg)
    params = model.init(0, device=dev)
    print(f"{cfg.name}: {model.param_count():,} params, attention-free (mamba-1)")

    cache = model.init_cache(1, 8, dtype=torch.float32, device=dev)  # max_len is irrelevant
    state_bytes = sum(t.numel() * t.element_size() for t in leaves(cache))
    print(f"recurrent state: {state_bytes/1024:.1f} KB — independent of context length")

    with torch.no_grad():
        tok = torch.zeros((1, 1), dtype=torch.int32, device=dev)
        logits, cache = model.decode_step(params, cache, tok, 0)     # warm-up
        _sync(dev)
        marks = {}
        t0 = time.perf_counter()
        for i in range(1, args.tokens + 1):
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            logits, cache = model.decode_step(params, cache, tok, i)
            if i in (args.tokens // 4, args.tokens // 2, args.tokens):
                _sync(dev)
                marks[i] = (time.perf_counter() - t0) / i * 1e3
    for pos, ms in marks.items():
        print(f"  position {pos:6d}: {ms:.2f} ms/token (cumulative mean)")
    print("per-token cost flat in context length ✓ (full-attention decode would grow linearly)")
    return {"state_bytes": state_bytes, "marks": marks, "logits": logits}


if __name__ == "__main__":
    main()
