"""The port's roofline (``repro_torch.roofline``) against the reference's
(``repro.roofline``): ``model_flops`` equal for every arch and shape, and,
on the same synthetic dry-run records, each of ``analyze_record``'s three
terms equal to the reference's times the ratio of the two constant tables
(the H100's rates over the TPU v5e's), with the dominant term the
reference's wherever that ratio keeps the terms' order."""
import json

import numpy as np
import pytest

from repro.roofline import analysis as ref_analysis
from repro.roofline import constants as ref_constants
from repro_torch.configs import get_config, list_archs
from repro_torch.launch.specs import cell_plan
from repro_torch.roofline import analysis, constants

ARCHS = list(list_archs())
CELLS = [(a, s, kind) for a in ARCHS for s, (kind, _skip) in cell_plan(get_config(a)).items()]
# each term: the port's time over the reference's for the same record
RATIO = {"compute": ref_constants.PEAK_FLOPS_BF16 / constants.PEAK_FLOPS_BF16,
         "memory": ref_constants.HBM_BW / constants.HBM_BW,
         "collective": ref_constants.ICI_BW / constants.LINK_BW}


def test_constants_are_the_h100s():
    assert constants.PEAK_FLOPS_BF16 == 989.4e12
    assert constants.HBM_BW == 3.35e12
    assert constants.LINK_BW == 450e9
    assert constants.HBM_PER_CHIP == 85_017_493_504
    assert constants.CHIPS_PER_POD == 256
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "HBM_PER_CHIP"):
        assert getattr(constants, name) != getattr(ref_constants, name), name
    assert constants.LINK_BW != ref_constants.ICI_BW
    assert not hasattr(constants, "ICI_BW")


@pytest.mark.parametrize("arch,shape,kind", CELLS)
def test_model_flops_match_reference(arch, shape, kind):
    assert analysis.model_flops(arch, shape, kind) == ref_analysis.model_flops(arch, shape, kind)


def _records(seed: int):
    """One synthetic ``ok`` record a cell and mesh: per-device flops, bytes
    and collective bytes drawn over six decades, so every term dominates
    somewhere."""
    rng = np.random.default_rng(seed)
    out = []
    for arch, shape, kind in CELLS:
        for mesh in ("single_pod", "multi_pod"):
            out.append({
                "arch": arch, "shape": shape, "mesh": mesh, "kind": kind, "status": "ok",
                "parsed_cost": {"flops": float(10 ** rng.uniform(9, 15)),
                                "bytes": float(10 ** rng.uniform(6, 12))},
                "collective_bytes": {"total": float(10 ** rng.uniform(5, 11))},
                "memory_analysis": {"argument_size_in_bytes": int(10 ** rng.uniform(6, 11))},
            })
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_analyze_record_scales_the_references_terms(seed):
    kept, moved = 0, 0
    for rec in _records(seed):
        got, want = analysis.analyze_record(rec), ref_analysis.analyze_record(rec)
        scaled = {}
        for term, ratio in RATIO.items():
            scaled[term] = want[f"{term}_s"] * ratio
            assert got[f"{term}_s"] == pytest.approx(scaled[term], rel=1e-12), (rec, term)
        assert got["model_flops"] == want["model_flops"]
        assert got["useful_ratio"] == pytest.approx(want["useful_ratio"], rel=1e-12)
        assert got["chips"] == want["chips"]
        assert got["dominant"] == max(scaled, key=scaled.get)
        ref_terms = {t: want[f"{t}_s"] for t in RATIO}
        if sorted(RATIO, key=scaled.get) == sorted(RATIO, key=ref_terms.get):
            assert got["dominant"] == want["dominant"]
            kept += 1
        else:
            moved += 1
        hbm = rec["memory_analysis"]["argument_size_in_bytes"]
        assert got["fits_hbm"] == (hbm <= constants.HBM_PER_CHIP)
        assert got["hbm_gb_per_chip"] == hbm / 2**30
        assert "hbm_gb_tpu_est" not in got and "memory_upper_s" not in got
    assert kept > 0 and moved > 0         # both branches are exercised


def test_skipped_and_error_records_give_no_row():
    rec = {"arch": "glm4-9b", "shape": "long_500k", "mesh": "single_pod", "kind": "decode",
           "status": "skipped", "skip_reason": "x"}
    assert analysis.analyze_record(rec) is None
    assert analysis.analyze_record(dict(rec, status="error")) is None


def test_build_table_and_markdown(tmp_path, capsys):
    recs = [r for r in _records(2) if r["arch"] == "llama3.2-1b"]
    recs.append({"arch": "llama3.2-1b", "shape": "long_500k", "mesh": "single_pod",
                 "kind": "decode", "status": "skipped", "skip_reason": "full attention"})
    for r in recs:
        (tmp_path / f"{r['arch']}__{r['shape']}__{r['mesh']}.json").write_text(json.dumps(r))
    rows = analysis.build_table(str(tmp_path), "single_pod")
    assert [r["shape"] for r in rows] == sorted(r["shape"] for r in rows)
    ok = [r for r in rows if r["status"] == "ok"]
    assert len(ok) == 3 and all(r["hint"] == analysis._MOVE_HINTS[r["dominant"]] for r in ok)
    assert set(analysis._MOVE_HINTS) == set(ref_analysis._MOVE_HINTS)
    assert not any("TPU" in h or "ICI" in h for h in analysis._MOVE_HINTS.values())
    md = analysis.to_markdown(rows)
    assert md.count("\n") == len(rows) + 1 and "| llama3.2-1b | long_500k |" in md
    analysis.main(["--dryrun", str(tmp_path), "--json", str(tmp_path / "t.json"),
                   "--md", str(tmp_path / "t.md")])
    assert capsys.readouterr().out.strip() == md
    assert json.loads((tmp_path / "t.json").read_text()) == rows
