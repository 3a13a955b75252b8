"""Batched serving with continuous batching, the PyTorch/CUDA twin of
``examples/serve_lm.py``: submit a wave of prompts and decode them through
the slotted engine (kernel K4 for every prefill's attention on the card).

    PYTHONPATH=src python examples_torch/serve_lm.py [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import Model
from repro_torch.serve import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("llama3.2-1b", smoke=True).replace(dtype="float32")
    model = Model(cfg)
    params = model.init(0, device=dev)
    print(f"serving {cfg.name} ({model.param_count():,} params), 4 slots")

    engine = Engine(cfg, params, max_batch=4, max_len=128, prompt_buckets=(8, 16, 32),
                    device=dev)
    rng = np.random.default_rng(0)
    n_req = 10
    t0 = time.perf_counter()
    for uid in range(n_req):
        plen = int(rng.integers(2, 12))
        prompt = rng.integers(0, cfg.vocab_size, plen).tolist()
        engine.submit(Request(uid=uid, prompt=prompt, max_new_tokens=12))
    done = engine.run()
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done)
    print(f"completed {len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s on {dev})")
    for r in sorted(done, key=lambda r: r.uid)[:3]:
        print(f"  req{r.uid}: {r.output}")
    return done


if __name__ == "__main__":
    main()
