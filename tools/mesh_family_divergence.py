"""How far the mesh trainer's gradients part from one device's for the ssm, MLA and moe families: ``python3 tools/mesh_family_divergence.py``.

Needs one CUDA card (about 40 GB free) and ``nvcc``. For falcon-mamba-7b,
minicpm3-4b and qwen3-moe-30b-a3b at FULL width and 2 layers (the config of
``chip_smoke.py`` phase 18's f32 step), weights drawn from seed 0 and one
batch of 8 x 128 tokens (``lm_batch``, seed 0), prints each leaf's gradient
difference, relative to that leaf's largest value, of:

- f32, against one device on the kernel lane (K5 or K4):
  - the 2x2 (data, model) mesh of ``[cuda:0] * 4`` on the kernel lane
    (what phase 18 holds);
  - the same mesh on the plain lane (``backend="torch"``): whether the
    kernel on the shards adds to the difference;
  - two controls on one device: the embedding table scaled by (1 + 2^-23)
    (``chip_smoke.ulp_params``, 16c's and 17c's control), and each of its
    entries moved by one ulp up or down at random
    (``chip_smoke.random_ulp_params``, phase 18's);
- f64 at 1 layer (2 do not fit the card with qwen3-moe's experts
  gathered at every position), the mesh against one device, both on the
  plain lane (the kernels take f32 and bf16 only): how far the mesh's
  arithmetic is from one device's once rounding is small (the model's f32
  parts, its norms' statistics among them, still round).

Shows whether a leaf the mesh parts past phase 18's 1e-3 is rounding (the
f64 row stays small, the controls part it too) or a fault (the f64 row
parts it as well). ~3 min after the build.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

ARCHS = (cs.SSM_ARCH, cs.MLA_ARCH, cs.MOE_ARCH)


def errors(grads, want) -> dict:
    from repro_torch.sharding.placed import gather
    from repro_torch.tree import leaves, leaves_with_path

    return {"/".join(p): cs.max_rel(gather(g).double(), w.double())
            for (p, g), w in zip(leaves_with_path(grads), leaves(want))}


def main() -> None:
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels import build
    from repro_torch.models import Model
    from repro_torch.runtime.elastic import make_mesh
    from repro_torch.sharding.placed import place
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.tree import tree_map

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(f"card: {cs.card_line()}")
    build.build(["flash_attention", "selective_scan"])
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    tc = TrainConfig(batch=cs.TRAIN_BATCH, seq_len=cs.TRAIN_SEQ)
    for arch in ARCHS:
        rows = {}
        for dtype in ("float32", "float64"):
            layers = cs.FAMILY_F32_LAYERS if dtype == "float32" else 1
            cfg = get_config(arch).replace(num_layers=layers, dtype=dtype)
            params = Model(cfg).init(0, device=dev)
            if dtype == "float64":
                params = tree_map(lambda p: p.double(), params)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in
                     lm_batch(cfg, cs.TRAIN_BATCH, cs.TRAIN_SEQ, seed=0).items()}
            single = Trainer(cfg, tc, device=dev)
            single.model.backend = "auto" if dtype == "float32" else "torch"
            want, _ = single.grads_of(params, batch)
            for backend in (("auto", "torch") if dtype == "float32" else ("torch",)):
                trainer = Trainer(cfg, tc, mesh=make_mesh([dev] * 4, model_parallel=2))
                trainer.model.backend = backend
                placed = tree_map(place, params, trainer.state_shardings().params)
                got, _ = trainer.mesh_grads_of(placed, trainer._microbatches(batch)[0])
                lane = "kernel" if backend == "auto" else "plain"
                rows[f"{dtype[5:]} mesh 2x2, {lane} lane"
                     + ("" if dtype == "float32" else ", 1 layer")] = errors(got, want)
                del got, placed, trainer
            if dtype == "float32":
                for label, moved in (("control: table x (1 + 2^-23)", cs.ulp_params(params)),
                                     ("control: table +-1 ulp", cs.random_ulp_params(params))):
                    ctrl, _ = single.grads_of(moved, batch)
                    rows[f"32 {label}"] = errors(ctrl, want)
                    del ctrl
            del want, params
            cs.free_weights()
        first = next(iter(rows.values()))
        order = sorted(first, key=first.get, reverse=True)
        print(f"{arch}, FULL width, {cs.FAMILY_F32_LAYERS} layers (f64: 1): each leaf's "
              f"gradient difference, relative to its largest value")
        for label, errs in rows.items():
            print(f"  {label}: worst {max(errs.values()):.3g} ({max(errs, key=errs.get)}); "
                  + ", ".join(f"{leaf} {errs[leaf]:.3g}" for leaf in order if leaf in errs))
    print(f"card: {cs.card_line()}")


if __name__ == "__main__":
    main()
