"""EWA projection of isotropic 3D Gaussians to screen space.

Parity: `vtgaussian_slam_tpu/ops/rasterizer/projection.py`, isotropic fast
path: Sigma2D = s^2 J J^T + 0.3 I with J the perspective Jacobian at the
frustum-clamped view direction (1.3 tan(fov/2)), near cull at z <= 0.2.
Every shipped config is isotropic; the anisotropic path waits for the
generic renderers of a later slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..camera import Camera

NEAR_CULL = 0.2
COV2D_DILATION = 0.3
RADIUS_SIGMA = 3.0


class ProjectedGaussians(NamedTuple):
    mean2d: torch.Tensor    # (N, 2) pixel coordinates
    conic: torch.Tensor     # (N, 3) inverse 2D covariance (a, b, c)
    depth: torch.Tensor     # (N,) camera z (inf when culled)
    radius: torch.Tensor    # (N,) bounding radius in pixels (0 if culled)
    opacity: torch.Tensor   # (N,) post-sigmoid opacity
    valid: torch.Tensor     # (N,) bool


def project_gaussians(means_cam: torch.Tensor, quats: torch.Tensor,
                      scales: torch.Tensor, opacities: torch.Tensor,
                      cam: Camera, active: torch.Tensor | None = None
                      ) -> ProjectedGaussians:
    """Project camera-frame isotropic Gaussians; `scales` is (N, 1)."""
    if scales.shape[1] != 1:
        raise NotImplementedError(
            "anisotropic projection arrives with the generic renderers")
    x, y, z = means_cam[:, 0], means_cam[:, 1], means_cam[:, 2]
    valid = z > NEAR_CULL
    if active is not None:
        valid = valid & active
    z_safe = torch.where(valid, z, torch.ones_like(z))

    limx = 1.3 * cam.tanfovx
    limy = 1.3 * cam.tanfovy
    tx = torch.clamp(x / z_safe, -limx, limx) * z_safe
    ty = torch.clamp(y / z_safe, -limy, limy) * z_safe
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z
    j00 = cam.fx * inv_z
    j02 = -cam.fx * tx * inv_z2
    j11 = cam.fy * inv_z
    j12 = -cam.fy * ty * inv_z2

    s2 = scales[:, 0] * scales[:, 0]
    v00 = s2 * (j00 * j00 + j02 * j02) + COV2D_DILATION
    v01 = s2 * (j02 * j12)
    v11 = s2 * (j11 * j11 + j12 * j12) + COV2D_DILATION

    det = v00 * v11 - v01 * v01
    valid = valid & (det > 0)
    det_safe = torch.where(det > 0, det, torch.ones_like(det))
    inv_det = 1.0 / det_safe
    conic = torch.stack([v11 * inv_det, -v01 * inv_det, v00 * inv_det], -1)

    mid = 0.5 * (v00 + v11)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det_safe, min=0.1))
    radius = torch.where(valid, torch.ceil(RADIUS_SIGMA * torch.sqrt(lam1)),
                         torch.zeros_like(lam1))

    px = cam.fx * x * inv_z + cam.cx - 0.5
    py = cam.fy * y * inv_z + cam.cy - 0.5
    mean2d = torch.stack([px, py], -1)
    mean2d = torch.where(valid[:, None], mean2d,
                         torch.full_like(mean2d, -1e6))
    return ProjectedGaussians(
        mean2d=mean2d, conic=conic,
        depth=torch.where(valid, z, torch.full_like(z, float("inf"))),
        radius=radius, opacity=opacities, valid=valid)
