"""Structural Similarity Index (paper Eq. 20, used for Fig. 7 correctness).

Standard Wang et al. SSIM with an 11x11 Gaussian window (sigma = 1.5),
C1 = (0.01 L)^2, C2 = (0.03 L)^2: ``repro.core.ssim`` in plain PyTorch,
the same separable valid-mode filter in the same tap order. The reference
has no kernel for it, and neither has the port.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["ssim"]


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(ax ** 2) / (2.0 * sigma ** 2))
    g /= g.sum()
    return g.astype(np.float32)


def _filter2(x: torch.Tensor, win: np.ndarray) -> torch.Tensor:
    """Separable valid-mode Gaussian filtering over the last two axes."""
    k = win.shape[0]
    # horizontal
    out_w = x.shape[-1] - k + 1
    acc = None
    for t in range(k):
        term = x[..., :, t: t + out_w] * float(win[t])
        acc = term if acc is None else acc + term
    x = acc
    # vertical
    out_h = x.shape[-2] - k + 1
    acc = None
    for t in range(k):
        term = x[..., t: t + out_h, :] * float(win[t])
        acc = term if acc is None else acc + term
    return acc


def ssim(
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    data_range: Optional[float] = None,
    win_size: int = 11,
    sigma: float = 1.5,
) -> torch.Tensor:
    """Mean SSIM between images ``x`` and ``y`` of shape ``(..., H, W)``.

    Returns a scalar per leading batch element (shape ``(...)``), in f32,
    on the inputs' device. ``data_range`` None takes the larger of the two
    images' dynamic ranges per image (at least 1e-8).
    """
    x = torch.as_tensor(x).to(torch.float32)
    y = torch.as_tensor(y).to(device=x.device, dtype=torch.float32)
    if data_range is None:
        rng = torch.maximum(
            x.amax(dim=(-2, -1)) - x.amin(dim=(-2, -1)),
            y.amax(dim=(-2, -1)) - y.amin(dim=(-2, -1)),
        )
        rng = rng.clamp_min(1e-8)[..., None, None]
    else:
        rng = torch.tensor(data_range, dtype=torch.float32, device=x.device)

    c1 = (0.01 * rng) ** 2
    c2 = (0.03 * rng) ** 2
    win = _gaussian_window(win_size, sigma)

    mu_x = _filter2(x, win)
    mu_y = _filter2(y, win)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_xx = _filter2(x * x, win) - mu_xx
    sigma_yy = _filter2(y * y, win) - mu_yy
    sigma_xy = _filter2(x * y, win) - mu_xy

    num = (2.0 * mu_xy + c1) * (2.0 * sigma_xy + c2)
    den = (mu_xx + mu_yy + c1) * (sigma_xx + sigma_yy + c2)
    return (num / den).mean(dim=(-2, -1))
