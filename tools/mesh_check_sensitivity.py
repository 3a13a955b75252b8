"""Whether ``chip_smoke.py``'s f32 mesh checks (phases 18 and 19) can fail: ``python3 tools/mesh_check_sensitivity.py``.

Needs one CUDA card (about 60 GB free) and ``nvcc``. At FULL width, weights
drawn from seed 0 and one batch of 8 rows (``lm_batch``, seed 0), prints:

- qwen3-moe-30b-a3b (2 layers in f32, 1 in f64), at the init's weights and
  at fan-in scale (``chip_smoke.fan_in_params``): one step on the 2x2 mesh
  of ``[cuda:0] * 4`` against one device, with how many (token, slot) pairs
  the mesh routes to another expert or keeps otherwise, the router logits'
  spread and least gap between the k-th and (k+1)-th logit, and the
  gradients' largest difference relative to each leaf's largest value (f64:
  the plain lane, every f32 part in f64). Shows why the moe family's f32
  step is not held at fan-in scale: a near tie flips there in f32.
- zamba2-2.7b, whisper-large-v3 and pixtral-12b at their f32 check's depths,
  with a fault planted at run time (the attention output of every mesh
  position at ``model`` index 1 multiplied by 1.01; the code on disk is not
  changed): ``chip_smoke.mesh_step_against_one`` at the init's weights and
  at fan-in scale, and ``chip_smoke.mesh_layer_local`` at fan-in scale, each
  with its checks counted instead of raised: how many fail, the worst leaf
  and the three largest ratios to the one-ulp control. Shows that at the
  init's weights the fault can hide under the controls (whisper's part its
  gradients by their whole size) and that at fan-in scale it cannot.

~3 min after the build.
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

PLANT = 1.01                     # the attention output of model index 1, scaled


def moe_routing(dev) -> None:
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import Model
    from repro_torch.models.moe import record_routing
    from repro_torch.runtime.elastic import make_mesh
    from repro_torch.sharding.placed import gather, place
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.tree import leaves, leaves_with_path, tree_map

    for dtype, layers in (("float32", 2), ("float64", 1)):
        cfg = cs.cut_config(cs.MOE_ARCH, layers, dtype=dtype)
        k = cfg.num_experts_per_tok
        tc = TrainConfig(batch=cs.TRAIN_BATCH, seq_len=cs.TRAIN_SEQ)
        init = Model(cfg).init(0, device=dev)
        batch = {n: torch.from_numpy(v).to(dev)
                 for n, v in lm_batch(cfg, cs.TRAIN_BATCH, cs.TRAIN_SEQ, seed=0).items()}
        single = Trainer(cfg, tc, device=dev)
        trainer = Trainer(cfg, tc, mesh=make_mesh([dev] * 4, model_parallel=2), device=dev)
        if dtype == "float64":
            single.model.backend = trainer.model.backend = "torch"
        for label in ("the init", "fan-in"):
            params = init if label == "the init" else cs.fan_in_params(cfg, init)
            if dtype == "float64":
                params = tree_map(lambda p: p.double(), params)
            with cs.f64_throughout() if dtype == "float64" else contextlib.nullcontext():
                with record_routing() as one:
                    want, _ = single.grads_of(params, batch)
                placed = tree_map(place, params, trainer.state_shardings().params)
                with record_routing() as got:
                    grads, _ = trainer.mesh_grads_of(placed, trainer._microbatches(batch)[0])
            errs = {"/".join(p): cs.max_rel(gather(g), w)
                    for (p, g), w in zip(leaves_with_path(grads), leaves(want))}
            worst = max(errs, key=errs.get)
            idx1, idx2 = (torch.cat([e[1] for e in log]) for log in (one, got))
            kept1, kept2 = (torch.cat([e[2] for e in log]) for log in (one, got))
            logits = torch.cat([e[0] for e in one]).detach().float()
            top = logits.topk(k + 1, dim=-1).values
            gap = top[:, k - 1] - top[:, k]
            print(f"{cfg.name} {dtype[5:]}, {layers} layers, {label} weights: of "
                  f"{idx1.numel()} (token, slot) pairs the mesh routes "
                  f"{int((idx1 != idx2).sum())} to other experts and keeps "
                  f"{int((kept1 != kept2).sum())} otherwise; router logits' std "
                  f"{float(logits.std()):.3g}, k-th gap least {float(gap.min()):.3g}, median "
                  f"{float(gap.median()):.3g}; gradients within {errs[worst]:.3g} ({worst})",
                  flush=True)
            del want, grads, placed, params
        del init, single, trainer
        cs.free_weights()


def planted(dev) -> None:
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import Model
    from repro_torch.models import attention as attn_mod
    from repro_torch.runtime.elastic import make_mesh
    from repro_torch.train import TrainConfig, Trainer

    real_attention, real_check = attn_mod.attention_mesh, cs.check
    failures: list = []

    def faulty(*a, **kw):
        out = real_attention(*a, **kw)
        return {pos: t * PLANT if pos[-1] == 1 else t for pos, t in out.items()}

    attn_mod.attention_mesh = faulty
    cs.check = lambda cond, msg: None if cond else failures.append(msg)
    try:
        for arch, _depth, seq, layers, _f64, _rows, phase in cs.FAMILY_MESH:
            if phase != "19":
                continue
            cfg = cs.cut_config(arch, layers, dtype="float32")
            tc = TrainConfig(batch=cs.TRAIN_BATCH, seq_len=seq)
            params = Model(cfg).init(0, device=dev)
            batch = {n: torch.from_numpy(v).to(dev)
                     for n, v in lm_batch(cfg, cs.TRAIN_BATCH, seq, seed=0).items()}
            single = Trainer(cfg, tc, device=dev)
            trainer = Trainer(cfg, tc, mesh=make_mesh([dev] * 4, model_parallel=2), device=dev)
            for label in ("the init", "fan-in"):
                if label == "fan-in":
                    params = cs.fan_in_params(cfg, params)
                failures.clear()
                st = cs.mesh_step_against_one(cfg, params, batch, single, trainer)
                sm = cs.step_summary(st)
                ratios = sorted(((st["errs"][n] / max(st["control"][n], 1e-30), n)
                                 for n in st["errs"]), reverse=True)[:3]
                print(f"planted x {PLANT}, {arch}, {layers} layers, one step at {label} "
                      f"weights: {len(failures)} checks fail; gradients within "
                      f"{sm['grad_err']:.3g} ({sm['grad_err_leaf']}), the control up to "
                      f"{sm['control_grad_err']:.3g}; largest ratios to the control "
                      + ", ".join(f"{r:.3g} ({n})" for r, n in ratios), flush=True)
            failures.clear()
            local = cs.mesh_layer_local(cfg, params, batch, trainer, control=True)
            blocks = {n: v for n, v in local.items() if n.startswith(cs.BLOCKS)}
            print(f"planted x {PLANT}, {arch}, each block at fan-in weights: {len(failures)} "
                  f"checks fail; outputs " + ", ".join(
                      f"{n} {v['out_err']:.3g} (control {v['control_out_err']:.3g})"
                      for n, v in blocks.items()), flush=True)
            del params, single, trainer, batch
            cs.free_weights()
    finally:
        attn_mod.attention_mesh, cs.check = real_attention, real_check


def main() -> None:
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(f"card: {cs.card_line()}")
    build.build(["flash_attention", "selective_scan"])
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    moe_routing(dev)
    planted(dev)
    print(f"card: {cs.card_line()}")


if __name__ == "__main__":
    main()
