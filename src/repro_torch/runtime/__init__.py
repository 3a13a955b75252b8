"""Serving-side runtime: fault injection, retry policy, step monitoring,
straggler policy and the elastic image mesh. Copies of the JAX-free modules
of ``repro.runtime``, and the image half of its ``elastic`` module over
``torch.device`` grids (the LM meshes' ``make_mesh``/``reshard`` are not
ported yet)."""
from repro_torch.runtime.chaos import (  # noqa: F401
    CorruptFrame,
    DeviceLoss,
    FaultPlan,
    InjectedFault,
    StepFail,
    Straggler,
)
from repro_torch.runtime.elastic import (  # noqa: F401
    IMAGE_MESH_AXES,
    ImageMesh,
    make_image_mesh,
    plan_image_mesh,
    plan_mesh,
)
from repro_torch.runtime.fault import FaultPolicy, FaultTolerantRunner, StepFailure  # noqa: F401
from repro_torch.runtime.monitor import StepMonitor  # noqa: F401
from repro_torch.runtime.stragglers import StragglerPolicy  # noqa: F401
