"""AdamW with global-norm clipping and ZeRO-1 optimizer-state axes, the
learning-rate schedules, and the compressed all-reduce with error feedback:
the port of ``repro.optim``."""
from repro_torch.optim import adamw, compress  # noqa: F401
from repro_torch.optim.adamw import AdamWState, global_norm, opt_state_axes  # noqa: F401
from repro_torch.optim.schedule import constant, warmup_cosine  # noqa: F401
