"""Runtime: fault injection, retry policy, step monitoring, straggler
policy and the elastic meshes. Copies of the JAX-free modules of
``repro.runtime``, and its ``elastic`` module over ``torch.device`` grids:
the LM meshes (``Mesh``, ``make_mesh``, ``reshard``) and the image mesh."""
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
    Mesh,
    make_image_mesh,
    make_mesh,
    plan_image_mesh,
    plan_mesh,
    reshard,
)
from repro_torch.runtime.fault import FaultPolicy, FaultTolerantRunner, StepFailure  # noqa: F401
from repro_torch.runtime.monitor import StepMonitor  # noqa: F401
from repro_torch.runtime.stragglers import StragglerPolicy  # noqa: F401
