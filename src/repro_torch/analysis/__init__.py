"""Kernel contract analyzer for the port's fused edge engine.

``python -m repro_torch.analysis`` sweeps every registered operator ×
backend × padding × output-mode combination, observes each call of the
``repro_torch.api`` facade (its aten ops, launches and reach) and, on the
card, the compiled K1-K3 (PTX and SASS) and their device programs, and
verifies the engine's contracts — fusion purity, contraction safety,
dtype ladder, ring pipeline, shared-memory budget, halo consistency,
determinism. The rule ids are the reference's (``repro.analysis``); the
README's port section maps each onto what the port checks.
"""

from repro_torch.analysis.rules import (
    RULES,
    AnalysisError,
    RingProgram,
    check_contraction_fences,
    check_device_program,
    check_dma_pipeline,
    check_dtype_ladder,
    check_fusion_purity,
    check_halo_window,
    check_kernel_accum_dtype,
    check_kernel_cardinality,
    check_launch_smem,
    check_static_registration,
    check_vmem_budget,
    tap_accumulation_bounds,
)
from repro_torch.analysis.ast_rules import scan_file, scan_source
from repro_torch.analysis.sweep import MODES, analyze, kernel_math_files
from repro_torch.analysis.trace import OpTrace, impulse_reach, trace_ops
from repro_torch.analysis.violations import (
    Report,
    Violation,
    load_baseline,
    render_coverage,
    write_baseline,
)

__all__ = [
    "RULES",
    "AnalysisError",
    "Report",
    "Violation",
    "RingProgram",
    "OpTrace",
    "analyze",
    "MODES",
    "kernel_math_files",
    "load_baseline",
    "write_baseline",
    "render_coverage",
    "scan_file",
    "scan_source",
    "trace_ops",
    "impulse_reach",
    "check_contraction_fences",
    "check_device_program",
    "check_dma_pipeline",
    "check_dtype_ladder",
    "check_fusion_purity",
    "check_kernel_accum_dtype",
    "check_halo_window",
    "check_kernel_cardinality",
    "check_launch_smem",
    "check_static_registration",
    "check_vmem_budget",
    "tap_accumulation_bounds",
]
