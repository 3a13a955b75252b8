"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke] [--device cuda|cpu]``.

The port of ``repro.launch.train`` on one device: random weights from
``--seed`` (f32 master weights, the forward in ``cfg.dtype``), the
:class:`~repro_torch.train.Trainer` over the synthetic
:class:`~repro_torch.data.loader.DataLoader`, and the fault-tolerant fit
loop with checkpoint/auto-resume under ``--ckpt DIR``. Prints the
reference's ``arch=``, ``params=`` and ``done: loss a -> b, restarts=...,
stragglers=...`` lines. Runs on the CUDA device by default (kernel K4 for
every attention, K5 for a Mamba-1 scan, each through its autograd
Function); ``--device cpu`` runs the plain PyTorch lanes. The mesh
(``--model-parallel``, ``--pods``) waits for the sharding rules (ROADMAP
queue 1 item 13.7): any value other than 1 raises. ``main`` returns the
history, the trainer (its ``state`` is the last state) and the parameter
count.
"""
from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.loader import DataLoader
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import Model
from repro_torch.train import TrainConfig, Trainer


def main(argv: Optional[Sequence[str]] = None) -> dict:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.model_parallel != 1 or args.pods != 1:
        raise SystemExit(f"--model-parallel {args.model_parallel} --pods {args.pods}: the port "
                         "trains on one device; the mesh waits for the sharding rules")
    cfg = get_config(args.arch, smoke=args.smoke)
    device = resolve_device(args.device)
    print(f"arch={cfg.name} devices=1 mesh={{}} device={device}")
    n_params = Model(cfg).param_count()
    print(f"params={n_params:,}")

    tc = TrainConfig(
        batch=args.batch, seq_len=args.seq, steps=args.steps,
        microbatches=args.microbatches, peak_lr=args.lr, seed=args.seed,
        checkpoint_every=max(10, args.steps // 5), log_every=max(1, args.steps // 20),
    )
    trainer = Trainer(cfg, tc, device=device)
    loader = DataLoader(cfg, tc.batch, tc.seq_len, seed=args.seed, device=device)
    manager = CheckpointManager(args.ckpt, keep=3, async_save=True) if args.ckpt else None
    hist = trainer.fit(loader, manager=manager)
    if manager:
        manager.wait()
    print(f"done: loss {hist['loss'][0]:.4f} -> {hist['loss'][-1]:.4f}, "
          f"restarts={hist['restarts']}, stragglers={trainer.monitor.stragglers()}")
    return {"history": hist, "trainer": trainer, "param_count": n_params}


if __name__ == "__main__":
    main()
