"""Deterministic synthetic inputs (numpy, shared frame-for-frame with ``repro``)."""
