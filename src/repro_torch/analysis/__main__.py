"""CLI for the port's kernel contract analyzer.

    python -m repro_torch.analysis                  # fast sweep, CPU (torch lane)
    python -m repro_torch.analysis --all            # full registry, every CPU half
    python -m repro_torch.analysis --all --backends torch,cuda   # the card half too
    python -m repro_torch.analysis --baseline ''    # no allowlist: every finding fails
    python -m repro_torch.analysis --write-baseline analysis_baseline_torch.json

The allowlist defaults to ``analysis_baseline_torch.json`` at the root of
the checkout.

Exit codes: 0 = no new violations, 1 = new violations, 2 = analyzer
misuse/internal error (a missing tool, ``--backends cuda`` without a card).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from repro_torch.analysis import (
    AnalysisError,
    analyze,
    load_baseline,
    render_coverage,
    write_baseline,
)


# The committed allowlist, at the root of the checkout.
DEFAULT_BASELINE = Path(__file__).resolve().parents[3] / "analysis_baseline_torch.json"


def _csv(value: Optional[str]) -> Optional[List[str]]:
    if value is None:
        return None
    return [v.strip() for v in value.split(",") if v.strip()]


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Contract analyzer for the port's fused edge engine.",
    )
    p.add_argument(
        "--all",
        action="store_true",
        dest="full",
        help="full sweep: every registered operator and plan, all paddings on "
        "the plain/NMS paths, and on the card every operator's device program",
    )
    p.add_argument("--operators", type=str, default=None, help="comma-separated subset")
    p.add_argument(
        "--backends",
        type=str,
        default=None,
        help="comma-separated: torch (the plain lane, default) and/or cuda "
        "(the kernels; needs the card)",
    )
    p.add_argument("--paddings", type=str, default=None, help="comma-separated subset")
    p.add_argument("--modes", type=str, default=None, help="comma-separated subset")
    p.add_argument("--layouts", type=str, default=None, help="gray,rgb")
    p.add_argument(
        "--plans",
        type=str,
        default=None,
        help="comma-separated StencilPlan subset for the fused multi-stage "
        "battery (default: canny5,blur_sobel5; '' skips it)",
    )
    p.add_argument(
        "--no-export",
        action="store_true",
        help="skip the device-program checks on the card (FUSE003, and the "
        "compiled PTX/SASS)",
    )
    p.add_argument("--json", type=str, default=None, help="write the JSON report here")
    p.add_argument(
        "--baseline",
        type=str,
        default=str(DEFAULT_BASELINE),
        help="allowlist file; only violations absent from it fail the run "
        "(default: the committed analysis_baseline_torch.json; '' for none)",
    )
    p.add_argument(
        "--write-baseline",
        type=str,
        default=None,
        help="write the run's violations as the new allowlist and exit 0",
    )
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)

    try:
        report = analyze(
            operators=_csv(args.operators),
            backends=_csv(args.backends),
            paddings=_csv(args.paddings),
            modes=_csv(args.modes),
            layouts=_csv(args.layouts),
            plans=_csv(args.plans),
            export=not args.no_export,
            full=args.full,
        )
        if args.baseline:
            report.apply_baseline(load_baseline(args.baseline))
    except (AnalysisError, ValueError, KeyError, OSError) as e:
        print(f"repro_torch.analysis: internal error: {e}", file=sys.stderr)
        return 2

    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(report.to_json_dict(), f, indent=2, sort_keys=True)
            f.write("\n")
    if args.write_baseline:
        write_baseline(args.write_baseline, report)
        print(f"wrote baseline ({len(report.violations)} entries) to "
              f"{args.write_baseline}")
        return 0
    print(report.render(verbose=args.verbose))
    print(render_coverage(report))
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
