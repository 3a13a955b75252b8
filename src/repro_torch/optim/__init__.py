"""AdamW with global-norm clipping, and the learning-rate schedules: the
port of ``repro.optim`` on one device. ZeRO-1's ``opt_state_axes`` and the
compressed all-reduce (``optim/compress.py``) wait for the sharding rules
(ROADMAP queue 1 item 13.7)."""
from repro_torch.optim import adamw  # noqa: F401
from repro_torch.optim.adamw import AdamWState, global_norm  # noqa: F401
from repro_torch.optim.schedule import constant, warmup_cosine  # noqa: F401
