"""How far the mesh trainer's gradients part from one device's for the ssm, MLA, moe, hybrid, encdec and vlm families: ``python3 tools/mesh_family_divergence.py [ARCH ...]``.

Needs one CUDA card (about 60 GB free) and ``nvcc``. For each arch of
``chip_smoke.FAMILY_MESH`` (falcon-mamba-7b, minicpm3-4b, qwen3-moe-30b-a3b,
zamba2-2.7b, whisper-large-v3, pixtral-12b) at FULL width and the depths
and rows of ``chip_smoke.py``'s f32 check and f64 step, weights drawn from
seed 0 and one batch (``lm_batch``, seed 0), prints each leaf's gradient
difference, relative to that leaf's largest value, of:

- f32, against one device on the kernel lane (K5 or K4), at the init's
  weights and at fan-in scale (``chip_smoke.fan_in_params``):
  - the 2x2 (data, model) mesh of ``[cuda:0] * 4`` on the kernel lane
    (what phases 18 and 19 hold);
  - the same mesh on the plain lane (``backend="torch"``): whether the
    kernel on the shards adds to the difference;
  - two controls on one device: the embedding table scaled by (1 + 2^-23)
    (``chip_smoke.ulp_params``, 16c's and 17c's control), and each of its
    entries (and the frames or patches, ``chip_smoke.ulp_frontends``)
    moved by one ulp up or down at random (phases 18's and 19's);
- f64, the mesh against one device, both on the plain lane (the kernels
  take f32 and bf16 only), with the model's f32 parts (its norms'
  statistics, Mamba-2's SSD among them) left to round and with every f32
  part in f64 too (``chip_smoke.f64_throughout``, what the phases hold).

Shows whether a leaf the mesh parts past 1e-3 is rounding (the f64 rows
stay small, the controls part it too) or a fault (the f64 rows part it as
well). ~3 min after the build for phase 18's archs; the ARCH arguments
pick some.
"""
from __future__ import annotations

import contextlib
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

# arch -> (f32 layers, tokens a row, f64 layers, f64 rows), as chip_smoke.py runs them
ARCHS = {arch: (f32_layers, seq, f64_layers, f64_rows)
         for arch, _depth, seq, f32_layers, f64_layers, f64_rows, _phase in cs.FAMILY_MESH}


def errors(grads, want) -> dict:
    from repro_torch.sharding.placed import gather
    from repro_torch.tree import leaves, leaves_with_path

    return {"/".join(p): cs.max_rel(gather(g, w.device).double(), w.double())
            for (p, g), w in zip(leaves_with_path(grads), leaves(want))}


def main() -> None:
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels import build
    from repro_torch.models import Model
    from repro_torch.runtime.elastic import make_mesh
    from repro_torch.sharding.placed import place
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.tree import tree_map

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    archs = sys.argv[1:] or list(ARCHS)
    print(f"card: {cs.card_line()}")
    build.build(["flash_attention", "selective_scan"])
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in archs:
        f32_layers, seq, f64_layers, f64_rows = ARCHS[arch]
        rows = {}
        runs = [("float32", f32_layers, cs.TRAIN_BATCH, False, "init"),
                ("float32", f32_layers, cs.TRAIN_BATCH, False, "fan-in"),
                ("float64", f64_layers, f64_rows, False, "init"),
                ("float64", f64_layers, f64_rows, True, "init")]
        for dtype, layers, n_rows, all_f64, weights in runs:
            cfg = cs.cut_config(arch, layers, dtype=dtype)
            tc = TrainConfig(batch=n_rows, seq_len=seq)
            params = Model(cfg).init(0, device=dev)
            if weights == "fan-in":
                params = cs.fan_in_params(cfg, params)
            if dtype == "float64":
                params = tree_map(lambda p: p.double(), params)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in
                     lm_batch(cfg, n_rows, seq, seed=0).items()}
            single = Trainer(cfg, tc, device=dev)
            single.model.backend = "auto" if dtype == "float32" else "torch"
            suffix = (f", {weights} weights" if dtype == "float32" else
                      f", {layers} layers, {n_rows} rows"
                      + (", every f32 part in f64" if all_f64 else ""))
            with cs.f64_throughout() if all_f64 else contextlib.nullcontext():
                want, _ = single.grads_of(params, batch)
                want = tree_map(lambda g: g.cpu(), want)
                for backend in (("auto", "torch") if dtype == "float32" else ("torch",)):
                    trainer = Trainer(cfg, tc, mesh=make_mesh([dev] * 4, model_parallel=2))
                    trainer.model.backend = backend
                    placed = tree_map(place, params, trainer.state_shardings().params)
                    got, _ = trainer.mesh_grads_of(placed, trainer._microbatches(batch)[0])
                    lane = "kernel" if backend == "auto" else "plain"
                    rows[f"{dtype[5:]} mesh 2x2, {lane} lane{suffix}"] = errors(got, want)
                    del got, placed, trainer
            if dtype == "float32":
                moved_batch = cs.ulp_frontends(batch)
                for label, moved, b in (
                        ("control: table x (1 + 2^-23)", cs.ulp_params(params), batch),
                        ("control: table (and frames, patches) +-1 ulp",
                         cs.random_ulp_params(params), moved_batch)):
                    ctrl, _ = single.grads_of(moved, b)
                    rows[f"32 {label}{suffix}"] = errors(ctrl, want)
                    del ctrl
            del want, params
            cs.free_weights()
        first = next(iter(rows.values()))
        order = sorted(first, key=first.get, reverse=True)
        print(f"{arch}, FULL width, {f32_layers} layers, {seq} tokens a row: each leaf's "
              f"gradient difference, relative to its largest value")
        for label, errs in rows.items():
            print(f"  {label}: worst {max(errs.values()):.3g} ({max(errs, key=errs.get)}); "
                  + ", ".join(f"{leaf} {errs[leaf]:.3g}" for leaf in order if leaf in errs))
    print(f"card: {cs.card_line()}")


if __name__ == "__main__":
    main()
