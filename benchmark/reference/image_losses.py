# Frozen copy of youreditableavatar_tpu_torch/ops/image_losses.py (the plain PyTorch path only).
"""Image losses: L1, SSIM/D-SSIM (11×11 Gaussian window), PSNR.

Counterpart of `youreditableavatar_tpu/ops/image_losses.py`. Images are
(H, W, C) as in the JAX package. The window convolution runs through
`conv2d`; callers on the card keep `torch.backends.cudnn.allow_tf32` off
for f32 results.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor


def l1_loss(pred: Tensor, target: Tensor) -> Tensor:
    return torch.mean(torch.abs(pred - target))




@functools.lru_cache()
def _gaussian_window(window_size: int, sigma: float) -> tuple:
    x = np.arange(window_size) - window_size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return tuple((g / g.sum()).tolist())


def _filter2d(img: Tensor, window: Tensor) -> Tensor:
    """Separable zero-padded ("SAME") Gaussian filter over (H, W, C)."""
    k = window.shape[0]
    x = img.permute(2, 0, 1)[:, None]  # (C, 1, H, W)
    x = F.conv2d(x, window.reshape(1, 1, 1, k), padding=(0, k // 2))
    x = F.conv2d(x, window.reshape(1, 1, k, 1), padding=(k // 2, 0))
    return x[:, 0].permute(1, 2, 0)


def ssim(pred: Tensor, target: Tensor, window_size: int = 11,
         sigma: float = 1.5, c1: float = 0.01**2, c2: float = 0.03**2) -> Tensor:
    """Mean SSIM over an (H, W, C) image pair in [0, 1]."""
    window = torch.tensor(_gaussian_window(window_size, sigma),
                          dtype=torch.float32, device=pred.device)
    mu_p = _filter2d(pred, window)
    mu_t = _filter2d(target, window)
    mu_p2 = mu_p * mu_p
    mu_t2 = mu_t * mu_t
    mu_pt = mu_p * mu_t
    sig_p = _filter2d(pred * pred, window) - mu_p2
    sig_t = _filter2d(target * target, window) - mu_t2
    sig_pt = _filter2d(pred * target, window) - mu_pt
    s = ((2 * mu_pt + c1) * (2 * sig_pt + c2)) / (
        (mu_p2 + mu_t2 + c1) * (sig_p + sig_t + c2)
    )
    return torch.mean(s)


def dssim(pred: Tensor, target: Tensor) -> Tensor:
    return (1.0 - ssim(pred, target)) / 2.0


def l1_dssim(pred: Tensor, target: Tensor, dssim_factor: float = 0.2) -> Tensor:
    """The 3DGS photometric loss: (1−λ)·L1 + λ·D-SSIM."""
    return (1.0 - dssim_factor) * l1_loss(pred, target) + dssim_factor * dssim(
        pred, target
    )


