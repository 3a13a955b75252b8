"""Deterministic synthetic inputs (numpy, shared frame-for-frame with
``repro``) and the prefetching loader that puts them on the device."""
