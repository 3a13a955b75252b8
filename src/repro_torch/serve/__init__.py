"""Serving: the LM engine (continuous batching), the paged KV cache, the
streaming engine and its degradation ladder."""
from repro_torch.serve.engine import Engine, Request  # noqa: F401
from repro_torch.serve.guard import (  # noqa: F401
    GuardPolicy,
    Health,
    Outcome,
    Shedder,
    StepGuard,
    quarantine_reason,
)
from repro_torch.serve.paged import PagedKVCache  # noqa: F401
from repro_torch.serve.streams import (  # noqa: F401
    StreamEngine,
    StreamRequest,
    StreamStats,
)
