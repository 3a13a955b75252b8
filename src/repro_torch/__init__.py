"""repro_torch — the PyTorch/CUDA port of the ``repro`` edge engine.

The package mirrors ``repro``'s module layout (``repro_torch/core/sobel.py``
is read against ``repro/core/sobel.py``, and so on) and imports only torch
and numpy. Its kernels are hand-written CUDA for Hopper (``sm_90a``) under
``repro_torch/kernels/csrc``; each sits beside a plain PyTorch version of
the same function.

Entry point: :func:`repro_torch.api.edge_detect`, which runs on the CUDA
device unless the caller passes ``device="cpu"``.
"""
