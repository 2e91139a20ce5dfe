"""SSIM for the mapping colour loss and MS-SSIM for evaluation.

Parity: `vtgaussian_slam_tpu/ops/ssim.py`.
  - `ssim` (the reference's calc_ssim): 11x11 Gaussian window, sigma 1.5,
    zero "same" padding, C1 = 0.01^2, C2 = 0.03^2, per-channel,
    mean-reduced.
  - `ms_ssim` (pytorch_msssim semantics, the reference's eval metric):
    VALID windows, up to 5 scales with the standard weights, 2x2 average
    pooling between scales.
The 2D window is outer(g, g), so the blur is two depthwise 1D convolutions
over one 15-channel stack. TF32 is off for cuDNN (package __init__), so
the convolutions run in float32.
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


def _blur(img: torch.Tensor, window: np.ndarray, same: bool = True
          ) -> torch.Tensor:
    """(C, H, W) -> separable Gaussian blur with zero 'same' padding, or
    over VALID windows only ((C, H - k + 1, W - k + 1))."""
    C = img.shape[0]
    k = window.shape[0]
    pad = k // 2 if same else 0
    w = torch.as_tensor(window, device=img.device, dtype=img.dtype)
    x = img[None]
    x = F.conv2d(x, w.view(1, 1, k, 1).expand(C, 1, k, 1).contiguous(),
                 padding=(pad, 0), groups=C)
    x = F.conv2d(x, w.view(1, 1, 1, k).expand(C, 1, 1, k).contiguous(),
                 padding=(0, pad), groups=C)
    return x[0]


def _ssim_terms(img1, img2, window, same: bool):
    """The SSIM and contrast-structure maps of a (C, H, W) pair."""
    C = img1.shape[0]
    bl = _blur(torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2]),
               window, same)
    mu1, mu2 = bl[0:C], bl[C:2 * C]
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = bl[2 * C:3 * C] - mu1_sq
    s2 = bl[3 * C:4 * C] - mu2_sq
    s12 = bl[4 * C:5 * C] - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    cs = (2 * s12 + c2) / (s1 + s2 + c2)
    lum = (2 * mu12 + c1) / (mu1_sq + mu2_sq + c1)
    return lum * cs, cs


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over a (C, H, W) image pair."""
    window = _gaussian_kernel1d(window_size, sigma)
    ssim_map, _ = _ssim_terms(img1, img2, window, same=True)
    return torch.mean(ssim_map)


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def ms_ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
            sigma: float = 1.5, data_range: float = 1.0) -> torch.Tensor:
    """Multi-scale SSIM of a (C, H, W) pair: VALID windows; scales dropped
    while the smallest side at the coarsest scale is under the window
    (3 scales at 48x64); each scale's mean cs and the last mean SSIM
    clipped to [0, 1] (the E[x^2] - E[x]^2 variance form cancels at f32 on
    near-identical images); between scales a 2x2 average pool that zero-pads
    an odd side on both ends and counts the pad."""
    img1 = img1 / data_range
    img2 = img2 / data_range
    window = _gaussian_kernel1d(window_size, sigma)
    levels = len(_MSSSIM_WEIGHTS)
    min_side = min(img1.shape[1], img1.shape[2])
    while levels > 1 and (min_side >> (levels - 1)) < window_size:
        levels -= 1
    mcs = []
    x, y = img1, img2
    for i in range(levels):
        ssim_map, cs_map = _ssim_terms(x, y, window, same=False)
        if i < levels - 1:
            mcs.append(torch.clamp(torch.mean(cs_map), 0.0, 1.0))
            pad = (x.shape[1] % 2, x.shape[2] % 2)
            x = F.avg_pool2d(x[None], 2, 2, padding=pad,
                             count_include_pad=True)[0]
            y = F.avg_pool2d(y[None], 2, 2, padding=pad,
                             count_include_pad=True)[0]
    msv = torch.clamp(torch.mean(ssim_map), 0.0, 1.0)
    out = msv ** _MSSSIM_WEIGHTS[levels - 1]
    for w, c in zip(_MSSSIM_WEIGHTS[: levels - 1], mcs):
        out = out * c ** w
    return out
