"""Operator registry and the variant ladder in plain PyTorch."""
