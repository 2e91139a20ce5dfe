"""SSIM for the mapping colour loss.

Parity: `vtgaussian_slam_tpu/ops/ssim.py:ssim` (the reference's calc_ssim):
11x11 Gaussian window, sigma 1.5, zero "same" padding, C1 = 0.01^2,
C2 = 0.03^2, per-channel, mean-reduced. The 2D window is outer(g, g), so the
blur is two depthwise 1D convolutions over one 15-channel stack. TF32 is
off for cuDNN (package __init__), so the convolutions run in float32.
MS-SSIM waits for the eval slice.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=4)
def _gaussian_kernel1d(window_size: int, sigma: float) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2)
               / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(img: torch.Tensor, window: np.ndarray) -> torch.Tensor:
    """(C, H, W) -> separable Gaussian blur with zero 'same' padding."""
    C = img.shape[0]
    k = window.shape[0]
    pad = k // 2
    w = torch.as_tensor(window, device=img.device, dtype=img.dtype)
    x = img[None]
    x = F.conv2d(x, w.view(1, 1, k, 1).expand(C, 1, k, 1).contiguous(),
                 padding=(pad, 0), groups=C)
    x = F.conv2d(x, w.view(1, 1, 1, k).expand(C, 1, 1, k).contiguous(),
                 padding=(0, pad), groups=C)
    return x[0]


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over a (C, H, W) image pair."""
    window = _gaussian_kernel1d(window_size, sigma)
    C = img1.shape[0]
    bl = _blur(torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2]),
               window)
    mu1, mu2 = bl[0:C], bl[C:2 * C]
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = bl[2 * C:3 * C] - mu1_sq
    s2 = bl[3 * C:4 * C] - mu2_sq
    s12 = bl[4 * C:5 * C] - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    cs = (2 * s12 + c2) / (s1 + s2 + c2)
    lum = (2 * mu12 + c1) / (mu1_sq + mu2_sq + c1)
    return torch.mean(lum * cs)
