"""Atomic, retained, resumable checkpoints in the reference's layout."""
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
