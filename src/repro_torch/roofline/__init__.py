"""Roofline terms of the dry run's cells at one H100's rates
(:mod:`~repro_torch.roofline.constants`, :mod:`~repro_torch.roofline.analysis`).

The reference's ``roofline/hlo.py`` has no counterpart: it is a cost model
of the compiled post-GSPMD HLO, and eager PyTorch has no HLO; the port's
dry run counts its step on ``meta`` tensors instead (``launch/dryrun.py``).
"""
from repro_torch.roofline.constants import (  # noqa: F401
    HBM_BW,
    HBM_PER_CHIP,
    LINK_BW,
    PEAK_FLOPS_BF16,
)
