"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke] [--device cuda|cpu] [--model-parallel M] [--pods P]``.

The port of ``repro.launch.train``: builds the largest mesh the devices
support (``runtime.elastic.make_mesh``, elastic), prints the reference's
``arch=... devices=N mesh={...}`` and ``params=`` lines, constructs the
:class:`~repro_torch.train.Trainer` (TP + FSDP shardings and ZeRO-1
moments when the mesh has more than one position, else one device) over
the synthetic :class:`~repro_torch.data.loader.DataLoader`, and drives the
fault-tolerant fit loop with checkpoint/auto-resume under ``--ckpt DIR``;
prints ``done: loss a -> b, restarts=..., stragglers=...``. Random weights
from ``--seed`` (f32 master weights, the forward in ``cfg.dtype``).

The devices are every visible CUDA device by default (kernel K4 for every
attention, K5 for a Mamba-1 scan, each through its autograd Function), or
the CPU under ``--device cpu`` (the plain PyTorch lanes). ``main(argv,
devices=...)`` takes the device list instead, as the servers do: a list
that repeats a device (``[torch.device("cuda:0")] * 4``) runs a real 2x2
mesh on one card. ``main`` returns the history, the trainer (its
``state`` is the last state), the mesh and the parameter count.
"""
from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.loader import DataLoader
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import Model
from repro_torch.runtime.elastic import make_mesh, visible_devices
from repro_torch.train import TrainConfig, Trainer


def _train_devices(device: str, devices) -> list:
    """``devices`` when the caller passes a list (each of ``device``'s
    type), else every visible CUDA device, or the one CPU device under
    ``--device cpu``."""
    if devices is None:
        dev = resolve_device(device)
        return [dev] if dev.type == "cpu" else visible_devices()
    devices = [torch.device(d) for d in devices]
    if not devices or any(d.type != torch.device(device).type for d in devices):
        raise ValueError(f"devices={devices} do not match --device {device}")
    return [resolve_device(d) for d in devices]


def main(argv: Optional[Sequence[str]] = None, devices: Optional[Sequence] = None) -> dict:
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

    cfg = get_config(args.arch, smoke=args.smoke)
    devices = _train_devices(args.device, devices)
    mesh = make_mesh(devices, model_parallel=args.model_parallel, pods=args.pods)
    print(f"arch={cfg.name} devices={len(devices)} mesh={mesh.shape}")
    on_mesh = mesh if mesh.size > 1 else None
    n_params = Model(cfg).param_count()
    print(f"params={n_params:,}")

    tc = TrainConfig(
        batch=args.batch, seq_len=args.seq, steps=args.steps,
        microbatches=args.microbatches, peak_lr=args.lr, seed=args.seed,
        checkpoint_every=max(10, args.steps // 5), log_every=max(1, args.steps // 20),
    )
    trainer = Trainer(cfg, tc, mesh=on_mesh, device=devices[0])
    loader = DataLoader(cfg, tc.batch, tc.seq_len, mesh=on_mesh, seed=args.seed,
                        device=devices[0])
    manager = CheckpointManager(args.ckpt, keep=3, async_save=True) if args.ckpt else None
    hist = trainer.fit(loader, manager=manager)
    if manager:
        manager.wait()
    print(f"done: loss {hist['loss'][0]:.4f} -> {hist['loss'][-1]:.4f}, "
          f"restarts={hist['restarts']}, stragglers={trainer.monitor.stragglers()}")
    return {"history": hist, "trainer": trainer, "mesh": mesh, "param_count": n_params}


if __name__ == "__main__":
    main()
