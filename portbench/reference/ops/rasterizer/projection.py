"""EWA projection of 3D Gaussians to screen space.

Parity: `vtgaussian_slam_tpu/ops/rasterizer/projection.py`: Sigma2D =
J Sigma3D J^T + 0.3 I with J the perspective Jacobian at the
frustum-clamped view direction (1.3 tan(fov/2)), near cull at z <= 0.2.
(N, 1) scales take the isotropic fast path Sigma3D = s^2 I; (N, 3) scales
build Sigma3D = R S S^T R^T from the normalized quaternions, expanded
elementwise as the JAX package does. Differentiable: the generic render
route takes its gradient through here by autograd.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..camera import Camera
from ..geometry import normalize

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
    """Project camera-frame Gaussians; `scales` is (N, 1) or (N, 3)
    post-exp standard deviations, `quats` (N, 4) wxyz camera-frame
    rotations (read only when anisotropic)."""
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

    if scales.shape[1] == 1:
        s2 = scales[:, 0] * scales[:, 0]
        v00 = s2 * (j00 * j00 + j02 * j02) + COV2D_DILATION
        v01 = s2 * (j02 * j12)
        v11 = s2 * (j11 * j11 + j12 * j12) + COV2D_DILATION
    else:
        q = normalize(quats)
        r, xq, yq, zq = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
        R00 = 1 - 2 * (yq * yq + zq * zq)
        R01 = 2 * (xq * yq - r * zq)
        R02 = 2 * (xq * zq + r * yq)
        R10 = 2 * (xq * yq + r * zq)
        R11 = 1 - 2 * (xq * xq + zq * zq)
        R12 = 2 * (yq * zq - r * xq)
        R20 = 2 * (xq * zq - r * yq)
        R21 = 2 * (yq * zq + r * xq)
        R22 = 1 - 2 * (xq * xq + yq * yq)
        s0, s1, s2_ = scales[:, 0] ** 2, scales[:, 1] ** 2, scales[:, 2] ** 2
        c00 = s0 * R00 * R00 + s1 * R01 * R01 + s2_ * R02 * R02
        c01 = s0 * R00 * R10 + s1 * R01 * R11 + s2_ * R02 * R12
        c02 = s0 * R00 * R20 + s1 * R01 * R21 + s2_ * R02 * R22
        c11 = s0 * R10 * R10 + s1 * R11 * R11 + s2_ * R12 * R12
        c12 = s0 * R10 * R20 + s1 * R11 * R21 + s2_ * R12 * R22
        c22 = s0 * R20 * R20 + s1 * R21 * R21 + s2_ * R22 * R22
        r0x = j00 * c00 + j02 * c02
        r0y = j00 * c01 + j02 * c12
        r0z = j00 * c02 + j02 * c22
        r1y = j11 * c11 + j12 * c12
        r1z = j11 * c12 + j12 * c22
        v00 = r0x * j00 + r0z * j02 + COV2D_DILATION
        v01 = r0y * j11 + r0z * j12
        v11 = r1y * j11 + r1z * j12 + COV2D_DILATION

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
