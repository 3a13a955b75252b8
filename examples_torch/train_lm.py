"""End-to-end training on the synthetic stream, the PyTorch/CUDA twin of
``examples/train_lm.py``: train an LM on the synthetic bigram stream with
checkpointing, fault tolerance and straggler monitoring (kernel K4 for
every attention on the card, through its autograd Function).

Default is a ~100M-param llama-style model for a few hundred steps;
``--preset tiny`` runs a CPU-friendly smoke in under a minute. Both train
under the config's activation rematerialisation (``remat=True``, policy
``minimal`` for the 100m model: each layer's input kept, its forward run
again in the backward; ``dots`` for tiny, llama3.2-1b's own).

    PYTHONPATH=src python examples_torch/train_lm.py --preset tiny --steps 30 --device cpu
    PYTHONPATH=src python examples_torch/train_lm.py --steps 300        # ~100M, on the card
"""
import argparse
import dataclasses
import logging
import tempfile

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.loader import DataLoader
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import Model
from repro_torch.train import TrainConfig, Trainer

PRESETS = {
    "tiny": dict(
        cfg=lambda: get_config("llama3.2-1b", smoke=True),
        tc=TrainConfig(batch=8, seq_len=64, steps=30, peak_lr=5e-3, warmup_steps=5,
                       checkpoint_every=10, log_every=5),
    ),
    "100m": dict(
        cfg=lambda: ModelConfig(
            name="llama-100m", family="dense", num_layers=12, d_model=768,
            num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048,
            vocab_size=32000, rope_theta=10_000.0,
        ),
        tc=TrainConfig(batch=8, seq_len=512, steps=300, peak_lr=3e-4,
                       warmup_steps=30, checkpoint_every=100, log_every=10),
    ),
}


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="100m", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir (default: fresh tmp dir; pass a path to test resume)")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    preset = PRESETS[args.preset]
    cfg = preset["cfg"]()
    tc = dataclasses.replace(preset["tc"])
    if args.steps:
        tc.steps = args.steps
    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix="repro_torch_train_")

    print(f"model: {cfg.name}  params={Model(cfg).param_count():,}")
    trainer = Trainer(cfg, tc, device=dev)
    loader = DataLoader(cfg, tc.batch, tc.seq_len, seed=0, device=dev)
    manager = CheckpointManager(ckpt_dir, keep=2, async_save=True)
    hist = trainer.fit(loader, manager=manager)
    manager.wait()
    if not hist["loss"]:
        print(f"nothing to do: checkpoint at {ckpt_dir} is already past --steps")
        return hist, trainer
    print(f"final loss: {hist['loss'][-1]:.4f} (start {hist['loss'][0]:.4f})")
    print(f"step-time median: {trainer.monitor.fleet_median()*1e3:.1f} ms")
    return hist, trainer


if __name__ == "__main__":
    main()
