"""Serving-side runtime: fault injection, retry policy, step monitoring and
straggler policy. Copies of the JAX-free modules of ``repro.runtime``; its
elastic mesh planner, which needs JAX, has no counterpart here yet."""
from repro_torch.runtime.chaos import (  # noqa: F401
    CorruptFrame,
    DeviceLoss,
    FaultPlan,
    InjectedFault,
    StepFail,
    Straggler,
)
from repro_torch.runtime.fault import FaultPolicy, FaultTolerantRunner, StepFailure  # noqa: F401
from repro_torch.runtime.monitor import StepMonitor  # noqa: F401
from repro_torch.runtime.stragglers import StragglerPolicy  # noqa: F401
