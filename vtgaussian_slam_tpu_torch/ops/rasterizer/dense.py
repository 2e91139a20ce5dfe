"""Dense (every Gaussian at every pixel) differentiable renderer.

Parity: `vtgaussian_slam_tpu/ops/rasterizer/dense.py`. The O(N * H * W)
reference that holds the tiled route (K4 on the card) from outside the
tile machinery: the same projection, one global depth sort, and the same
front-to-back blend (alpha = min(0.99, opacity * exp(power)), pairs below
1/255 skipped, a pixel ends before the Gaussian that would take its
transmittance below 1e-4), computed per chunk of Gaussians as a prefix
product with a per-pixel carry. Plain PyTorch ops on the inputs' device.
"""
from __future__ import annotations

import torch

from ..camera import Camera
from .blend import ALPHA_MAX, ALPHA_MIN, T_TERMINATE
from .projection import project_gaussians


def gaussian_alpha(mean2d, conic, opacity, pix, pair_valid):
    """(K, P) alpha of K Gaussians at P pixels (x, y)."""
    d = pix[None, :, :] - mean2d[:, None, :]
    dx, dy = d[..., 0], d[..., 1]
    a, b, c = conic[:, 0:1], conic[:, 1:2], conic[:, 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp(opacity[:, None] * torch.exp(power), max=ALPHA_MAX)
    keep = (power <= 0) & (alpha >= ALPHA_MIN) & pair_valid[:, None]
    return torch.where(keep, alpha, torch.zeros_like(alpha))


def blend_chunk(carry_T, accum, alpha, colors):
    """Blend one depth-ordered chunk (alpha (K, P), colors (K, C)) into
    (carry_T (P,), accum (P, C)); a pixel whose transmittance crosses the
    termination threshold is done for every later chunk."""
    log_om = torch.log1p(-alpha)
    cum = torch.cumsum(log_om, 0)
    T_after = carry_T[None, :] * torch.exp(cum)
    T_before = carry_T[None, :] * torch.exp(cum - log_om)
    include = T_after >= T_TERMINATE
    weight = torch.where(include, alpha * T_before, torch.zeros_like(alpha))
    accum = accum + weight.T @ colors
    T_last = T_after[-1]
    new_T = torch.where(T_last < T_TERMINATE, torch.zeros_like(T_last),
                        T_last)
    return new_T, accum


def render_dense(means_cam: torch.Tensor, quats: torch.Tensor,
                 scales: torch.Tensor, opacities: torch.Tensor,
                 colors: torch.Tensor, cam: Camera,
                 active: torch.Tensor | None = None, chunk: int = 256
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Render a (C, H, W) image and per-Gaussian pixel radii (N,), every
    Gaussian composited at every pixel in global depth order, `chunk`
    Gaussians at a time. Differentiable in every float input."""
    N, C = colors.shape
    H, W = cam.height, cam.width
    dev, dt = means_cam.device, means_cam.dtype
    proj = project_gaussians(means_cam, quats, scales, opacities, cam, active)
    order = torch.argsort(proj.depth, stable=True)  # culled (inf) last
    s_mean2d = proj.mean2d[order]
    s_conic = proj.conic[order]
    s_opac = proj.opacity[order]
    s_valid = proj.valid[order]
    s_colors = colors[order]
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    pix = torch.stack([xs, ys], -1).reshape(H * W, 2).to(dt)
    T = torch.ones((H * W,), dtype=dt, device=dev)
    accum = torch.zeros((H * W, C), dtype=dt, device=dev)
    for c0 in range(0, N, chunk):
        sl = slice(c0, c0 + chunk)
        alpha = gaussian_alpha(s_mean2d[sl], s_conic[sl], s_opac[sl], pix,
                               s_valid[sl])
        T, accum = blend_chunk(T, accum, alpha, s_colors[sl])
    return accum.T.reshape(C, H, W), proj.radius
