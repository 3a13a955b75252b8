"""Where the mesh trainer's f32 gradients part from one device's, by depth: ``python3 tools/mesh_lane_divergence.py``.

Needs one CUDA card (about 40 GB free) and ``nvcc``. Draws llama3.2-1b at
FULL width in f32 from seed 0 at 1, 2, 4 and 16 layers (16 is the whole
model, as ``chip_smoke.py`` phase 17c draws it), takes one batch of 8 x
128 tokens (``lm_batch``, seed 0), and prints each depth's loss and the
worst leaf's gradient difference, relative to that leaf's largest value,
of:

- the 2x2 (data, model) mesh of ``[cuda:0] * 4`` on the K4 lane against
  one device on the K4 lane (what phase 17c holds);
- the same mesh on the plain attention lane (``backend="torch"``), which
  shows whether K4 on the shards adds to the difference;
- one device's plain lane against its K4 lane (phase 16c's lanes);
- the control: one device with the embeddings moved by one ulp (x (1 +
  2^-23), ``chip_smoke.ulp_params``).

Shows how far tensor parallelism's reordered f32 sums carry through a
random-weight model's sharp attention, and why phase 17c holds a leaf past
1e-3 only where the control parts it past 1e-3 too. ~1 min after the build.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

DEPTHS = (1, 2, 4, 16)


def worst(grads, want) -> tuple:
    from repro_torch.sharding.placed import gather
    from repro_torch.tree import leaves, leaves_with_path

    errs = {"/".join(p): cs.max_rel(gather(g), w)
            for (p, g), w in zip(leaves_with_path(grads), leaves(want))}
    name = max(errs, key=errs.get)
    return errs[name], name


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
    build.build(["flash_attention"])
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    for layers in DEPTHS:
        cfg = get_config(cs.TRAIN_ARCH).replace(dtype="float32", num_layers=layers)
        tc = TrainConfig(batch=cs.TRAIN_BATCH, seq_len=cs.TRAIN_SEQ)
        params = Model(cfg).init(0, device=dev)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 lm_batch(cfg, cs.TRAIN_BATCH, cs.TRAIN_SEQ, seed=0).items()}
        single = Trainer(cfg, tc, device=dev)
        want, want_m = single.grads_of(params, batch)
        rows = []
        for backend in ("auto", "torch"):
            trainer = Trainer(cfg, tc, mesh=make_mesh([dev] * 4, model_parallel=2))
            trainer.model.backend = backend
            placed = tree_map(place, params, trainer.state_shardings().params)
            got, got_m = trainer.mesh_grads_of(placed, trainer._microbatches(batch)[0])
            rows.append((f"mesh 2x2 ({'K4' if backend == 'auto' else 'plain'} lane)",
                         float(got_m["loss"]), *worst(got, want)))
            del got, placed
        single.model.backend = "torch"
        plain, plain_m = single.grads_of(params, batch)
        rows.append(("one device, plain lane", float(plain_m["loss"]), *worst(plain, want)))
        del plain
        single.model.backend = "auto"
        ctrl, ctrl_m = single.grads_of(cs.ulp_params(params), batch)
        rows.append(("control: one ulp", float(ctrl_m["loss"]), *worst(ctrl, want)))
        del ctrl, want, params
        print(f"{layers} layers: one device (K4 lane) loss {float(want_m['loss']):.6f}")
        for label, loss, err, leaf in rows:
            print(f"  {label:26s} loss {loss:.6f}; gradients within {err:.3g} ({leaf})")
        cs.free_weights()
    print(f"card: {cs.card_line()}")


if __name__ == "__main__":
    main()
