"""Operator registry, the variant ladder and the pipeline pieces in plain
PyTorch."""
from repro_torch.core.pipeline import make_sharded_edge_fn, rgb_to_gray  # noqa: F401
