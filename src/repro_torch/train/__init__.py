"""The training loop (single device): ``TrainConfig``, ``TrainState``,
``Trainer``."""
from repro_torch.train.loop import TrainConfig, Trainer, TrainState  # noqa: F401
