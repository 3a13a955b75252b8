"""Roofline analysis over the dry-run records, at the H100's rates.

The port of ``repro.roofline.analysis``. Per (arch x shape x mesh) cell:
    compute term    = flops_per_device / PEAK_FLOPS_BF16            [s]
    memory term     = bytes_per_device / HBM_BW                     [s]
    collective term = collective_bytes_per_device / LINK_BW         [s]
The per-device flops, bytes and collective bytes are the dry run's
(``launch/dryrun.py``): products counted on ``meta`` tensors, the scans'
elementwise work reckoned from their shapes, one formula for the bytes and
one for each collective.

Also reported:
    MODEL_FLOPS  = 6*N*D (train) / 2*N*D (serve), N_active for MoE;
    useful ratio = MODEL_FLOPS / total counted FLOPs (recompute/dispatch waste);
    mfu_proxy    = time to deliver MODEL_FLOPS at peak / dominant term.

The reference's ``hbm_gb_tpu_est`` and ``memory_upper_s`` have no
counterpart. The first halves the compiled program's temporaries because
XLA:CPU legalises bf16 buffers to f32, and the port has no compiler whose
buffers need that correction; the second reads the unfused HLO byte count,
and the port has no HLO. ``hbm_gb_per_chip`` is the dry run's argument
bytes a device: no temporaries are counted (the record says so), so
``fits_hbm`` is a lower bound on what the step needs.

Usage: python -m repro_torch.roofline.analysis --dryrun DIR [--mesh single_pod]
           [--json out.json] [--md out.md]
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
from typing import Dict, List, Optional

from repro_torch.launch.mesh import MESH_SHAPES
from repro_torch.roofline.constants import HBM_BW, HBM_PER_CHIP, LINK_BW, PEAK_FLOPS_BF16

__all__ = ["model_flops", "analyze_record", "build_table", "to_markdown", "main"]


def _param_counts(arch: str):
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = get_config(arch)
    if cfg.family == "image":
        return cfg, 0, 0
    total = Model(cfg).param_count()
    active = total
    if cfg.family == "moe":
        e, k = cfg.num_experts, cfg.num_experts_per_tok
        expert_params = cfg.num_layers * 3 * cfg.d_model * cfg.d_ff * e
        active = total - int(expert_params * (1 - k / e))
    return cfg, total, active


def model_flops(arch: str, shape_name: str, kind: str) -> Dict[str, float]:
    """6*N*D (train) / 2*N*D (prefill) / 2*N*B (decode, per step)."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.specs import SOBEL_SHAPES

    cfg, total, active = _param_counts(arch)
    if cfg.family == "image":
        s = SOBEL_SHAPES[shape_name]
        px = s["batch"] * s["h"] * s["w"]
        # RG-v2 ladder: ~82 MAC/px = 164 flops/px (4-dir 5x5, DESIGN.md §1)
        return {"model_flops": 164.0 * px, "n_params": 0, "n_active": 0}
    sh = SHAPES[shape_name]
    if kind == "train":
        f = 6.0 * active * sh.global_batch * sh.seq_len
    elif kind == "prefill":
        f = 2.0 * active * sh.global_batch * sh.seq_len
    else:  # decode: one token per sequence
        f = 2.0 * active * sh.global_batch
    return {"model_flops": f, "n_params": total, "n_active": active}


def _chips(mesh_name: str) -> int:
    return math.prod(MESH_SHAPES[mesh_name][0])


def analyze_record(rec: Dict) -> Optional[Dict]:
    if rec.get("status") != "ok":
        return None
    chips = _chips(rec["mesh"])
    pc = rec.get("parsed_cost", {})
    flops_dev = float(pc.get("flops", 0.0))
    bytes_dev = float(pc.get("bytes", 0.0))
    coll_dev = float(rec.get("collective_bytes", {}).get("total", 0.0))

    mf = model_flops(rec["arch"], rec["shape"], rec["kind"])
    # image cells are elementwise (no products): analytic flops floor
    flops_dev = max(flops_dev, mf["model_flops"] / chips)
    terms = {"compute": flops_dev / PEAK_FLOPS_BF16, "memory": bytes_dev / HBM_BW,
             "collective": coll_dev / LINK_BW}
    dominant = max(terms, key=terms.get)

    useful_ratio = mf["model_flops"] / (flops_dev * chips) if flops_dev else 0.0
    ideal_t = mf["model_flops"] / (chips * PEAK_FLOPS_BF16)
    bound = max(terms.values())
    hbm = rec.get("memory_analysis", {}).get("argument_size_in_bytes", 0)
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "mesh": rec["mesh"],
        "kind": rec["kind"],
        "chips": chips,
        "compute_s": terms["compute"],
        "memory_s": terms["memory"],
        "collective_s": terms["collective"],
        "dominant": dominant,
        "model_flops": mf["model_flops"],
        "counted_flops_total": flops_dev * chips,
        "useful_ratio": useful_ratio,
        "mfu_proxy": ideal_t / bound if bound > 0 else 0.0,
        "hbm_gb_per_chip": hbm / 2**30,
        "fits_hbm": hbm <= HBM_PER_CHIP,
    }


_MOVE_HINTS = {
    "compute": "cut counted FLOPs that are not the model's (the plain attention's "
               "masked half, MoE capacity padding) or move the step onto the tensor "
               "cores' bf16 rate",
    "memory": "keep intermediates on chip (fused scan and attention kernels, bf16 "
              "activations, a chunked loss): one HBM touch per tensor",
    "collective": "reshard to cut the NVLink traffic (less `model` for small layers, "
                  "batch-parallel layout) or overlap the collectives with compute",
}


def build_table(dryrun_dir: str, mesh: str = "single_pod") -> List[Dict]:
    rows = []
    for f in sorted(glob.glob(os.path.join(dryrun_dir, f"*__{mesh}.json"))):
        with open(f) as fh:
            rec = json.load(fh)
        row = analyze_record(rec)
        if row is None:
            rows.append({"arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
                         "status": rec["status"], "skip_reason": rec.get("skip_reason", "")})
            continue
        row["status"] = "ok"
        row["hint"] = _MOVE_HINTS[row["dominant"]]
        rows.append(row)
    return rows


def to_markdown(rows: List[Dict]) -> str:
    out = [
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "MODEL_FLOPS | useful | mfu_proxy | HBM GB | fits |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r.get("status") != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | {r['status']} "
                       "| — | — | — | — | — |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} | {r['memory_s']:.3e} "
            f"| {r['collective_s']:.3e} | **{r['dominant']}** | {r['model_flops']:.2e} "
            f"| {r['useful_ratio']:.2f} | {r['mfu_proxy']:.3f} "
            f"| {r['hbm_gb_per_chip']:.1f} | {'yes' if r['fits_hbm'] else 'NO'} |"
        )
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="roofline table over the dry-run records")
    ap.add_argument("--dryrun", default="build/dryrun")
    ap.add_argument("--mesh", default="single_pod")
    ap.add_argument("--json", default=None, help="write the rows here (default: none)")
    ap.add_argument("--md", default=None, help="write the markdown table here (default: none)")
    args = ap.parse_args(argv)
    rows = build_table(args.dryrun, args.mesh)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    md = to_markdown(rows)
    if args.md:
        with open(args.md, "w") as f:
            f.write(md + "\n")
    print(md)


if __name__ == "__main__":
    main()
