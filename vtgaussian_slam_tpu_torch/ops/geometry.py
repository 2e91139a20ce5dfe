"""Differentiable geometry: quaternions, SE(3), back-projection.

Parity: `vtgaussian_slam_tpu/ops/geometry.py` (the functions the port
calls). Conventions are the reference's: quaternions are wxyz,
stored unnormalized and normalized on use; a camera pose is w2c with
w2c[:3, :3] = R(quat), w2c[:3, 3] = trans; back-projection uses
(x - cx + 0.5) / fx pixel centres and the x1.005 depth inflation.
"""
from __future__ import annotations

import torch


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along `dim` (torch.nn.functional.normalize semantics)."""
    n = torch.linalg.norm(v, dim=dim, keepdim=True)
    return v / torch.clamp(n, min=eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) (..., 4) wxyz -> rotation matrix (..., 3, 3); the
    quaternion is normalized first."""
    q = normalize(q)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
                        2 * (x * z + r * y)], -1)
    row1 = torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
                        2 * (y * z - r * x)], -1)
    row2 = torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x),
                        1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], -2)


def quat_mult(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product, wxyz, broadcast over leading dims."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], -1)


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4) wxyz by the
    best-conditioned candidate (matrix_to_quaternion semantics)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    q_abs_sq = torch.stack([
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    ], -1)
    q_abs = torch.sqrt(torch.clamp(q_abs_sq, min=0.0))
    cand = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
    ], -2)
    cand = cand / (2.0 * torch.clamp(q_abs[..., None], min=0.1))
    best = torch.argmax(q_abs, dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    return torch.gather(cand, -2, idx)[..., 0, :]


def pose_to_w2c(quat: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """(quat wxyz, trans 3) -> 4x4 w2c, batched over leading dims."""
    r = quat_to_rotmat(quat)
    top = torch.cat([r, trans[..., :, None]], -1)
    bottom = torch.zeros(quat.shape[:-1] + (1, 4), dtype=quat.dtype,
                         device=quat.device)
    # a fill on the device: assigning a Python float copies it from the
    # host, which a CUDA graph cannot capture (the tracking loop's p2p)
    bottom[..., 0, 3].fill_(1.0)
    return torch.cat([top, bottom], -2)


def w2c_to_pose(w2c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """4x4 w2c -> (quat wxyz, trans 3)."""
    return rotmat_to_quat(w2c[..., :3, :3]), w2c[..., :3, 3]


def invert_se3(T: torch.Tensor) -> torch.Tensor:
    """Invert rigid transform(s) (..., 4, 4) without a general solve."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -(Rt @ t[..., None])], -1)
    bottom = torch.zeros_like(T[..., 3:4, :])
    bottom[..., 0, 3].fill_(1.0)      # on the device, as in pose_to_w2c
    return torch.cat([top, bottom], -2)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 transform to (..., N, 3) points."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def relative_transformation(T1: torch.Tensor, T2: torch.Tensor) -> torch.Tensor:
    """T1^-1 @ T2: the pose of frame 2 relative to frame 1 ((..., 4, 4))."""
    return invert_se3(T1) @ T2


def backproject(depth: torch.Tensor, intrinsics: torch.Tensor,
                c2w: torch.Tensor | None = None, depth_factor: float = 1.005,
                pixel_center: float = 0.5) -> torch.Tensor:
    """Back-project a depth image (H, W) into 3D points (H*W, 3): rays at
    (x - cx + pixel_center) / fx, depth scaled by `depth_factor`; world
    frame when `c2w` is given."""
    H, W = depth.shape
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    x = torch.arange(W, dtype=depth.dtype, device=depth.device)
    y = torch.arange(H, dtype=depth.dtype, device=depth.device)
    xx = (x[None, :] - cx + pixel_center) / fx
    yy = (y[:, None] - cy + pixel_center) / fy
    z = depth * depth_factor
    pts = torch.stack([xx.expand(H, W) * z, yy.expand(H, W) * z, z], -1)
    pts = pts.reshape(-1, 3)
    if c2w is not None:
        pts = transform_points(c2w, pts)
    return pts


def mean_sq_dist_projective(depth_flat: torch.Tensor, fx, fy,
                            depth_factor: float = 1.005) -> torch.Tensor:
    """Per-pixel squared scale for new Gaussians: (z / ((fx+fy)/2))^2."""
    scale = depth_flat * depth_factor / ((fx + fy) / 2.0)
    return scale * scale


def backproject_at(depth: torch.Tensor, intrinsics: torch.Tensor,
                   rows: torch.Tensor, cols: torch.Tensor,
                   c2w: torch.Tensor | None = None) -> torch.Tensor:
    """Back-project selected pixels (row, col index tensors) to 3D points,
    with rays at (col - cx) / fx (no +0.5 centre) and depth factor 1: the
    keyframe-selection variant."""
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    z = depth[rows, cols]
    xx = (cols.to(depth.dtype) - cx) / fx
    yy = (rows.to(depth.dtype) - cy) / fy
    pts = torch.stack([xx * z, yy * z, z], -1)
    if c2w is not None:
        pts = transform_points(c2w, pts)
    return pts


def project_points(pts_cam: torch.Tensor, intrinsics: torch.Tensor,
                   eps: float = 1e-5):
    """Camera-frame points (N, 3) -> (uv (N, 2), z (N,)), z guarded by
    +eps as the selection code does."""
    proj = pts_cam @ intrinsics.T
    z = proj[:, 2] + eps
    uv = proj[:, :2] / z[:, None]
    return uv, z


def _gradient(x: torch.Tensor, dim: int) -> torch.Tensor:
    """numpy.gradient along `dim`: central differences inside, one-sided
    first differences at both ends."""
    n = x.shape[dim]
    a = x.narrow(dim, 0, 1)
    b = x.narrow(dim, 1, 1)
    y = x.narrow(dim, n - 2, 1)
    z = x.narrow(dim, n - 1, 1)
    mid = (x.narrow(dim, 2, n - 2) - x.narrow(dim, 0, n - 2)) / 2.0
    return torch.cat([b - a, mid, z - y], dim)


def depth_to_normals(depth: torch.Tensor, intrinsics: torch.Tensor
                     ) -> torch.Tensor:
    """Finite-difference camera-space normals (H, W) -> (H, W, 3): back-
    project (no pixel centre, factor 1), central differences along x and y,
    cross product, normalize."""
    H, W = depth.shape
    pts = backproject(depth, intrinsics, depth_factor=1.0,
                      pixel_center=0.0).reshape(H, W, 3)
    n = torch.linalg.cross(_gradient(pts, 1), _gradient(pts, 0), dim=-1)
    return normalize(n)


def frustum_mask(w2c: torch.Tensor, intrinsics: torch.Tensor,
                 points_world: torch.Tensor, H: int, W: int,
                 edge: float = 0.0) -> torch.Tensor:
    """In-image test of world points: strict bounds with an `edge` margin
    and z > 0 (z guarded by +1e-8)."""
    proj = transform_points(w2c, points_world) @ intrinsics.T
    z = proj[:, 2] + 1e-8
    uv = proj[:, :2] / z[:, None]
    return ((uv[:, 0] < W - edge) & (uv[:, 0] > edge)
            & (uv[:, 1] < H - edge) & (uv[:, 1] > edge) & (z > 0))


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of img (H, W) at pixel coordinates uv (N, 2), zero
    outside (grid_sample with align_corners=True and zero padding)."""
    H, W = img.shape
    x, y = uv[:, 0], uv[:, 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0

    def tap(yy, xx):
        inside = (xx >= 0) & (xx <= W - 1) & (yy >= 0) & (yy <= H - 1)
        xi = torch.clamp(xx, 0, W - 1).long()
        yi = torch.clamp(yy, 0, H - 1).long()
        return torch.where(inside, img[yi, xi], torch.zeros_like(x))

    return (tap(y0, x0) * (1 - wx) * (1 - wy) + tap(y0, x0 + 1) * wx * (1 - wy)
            + tap(y0 + 1, x0) * (1 - wx) * wy + tap(y0 + 1, x0 + 1) * wx * wy)


def visibility_mask(points_world: torch.Tensor, overlap_w2c: torch.Tensor,
                    intrinsics: torch.Tensor, overlap_depth: torch.Tensor,
                    thres: float) -> torch.Tensor:
    """Depth-consistency visibility of world points in an overlap view:
    |d_sample - z| < thres * min(d_sample, z) for the overlap camera's
    bilinearly sampled depth."""
    uv, z = project_points(transform_points(overlap_w2c, points_world),
                           intrinsics)
    d = bilinear_sample(overlap_depth, uv)
    return (d - z).abs() < thres * torch.minimum(d, z)


def constant_velocity_init(w2c_prev1: torch.Tensor,
                           w2c_prev2: torch.Tensor) -> torch.Tensor:
    """Forward-propagated pose init: c2w_new = c2w1 @ inv(c2w2) @ c2w1."""
    c2w1 = invert_se3(w2c_prev1)
    c2w2 = invert_se3(w2c_prev2)
    init_c2w = c2w1 @ invert_se3(c2w2) @ c2w1
    return invert_se3(init_c2w)


def constant_velocity_init_multiavg(w2c_prev1: torch.Tensor,
                                    w2c_prev2: torch.Tensor,
                                    w2c_prev3: torch.Tensor) -> torch.Tensor:
    """Two-step-averaged forward propagation: init_c2w = ((c2w2 inv(c2w3)
    + c2w1 inv(c2w2)) / 2) @ c2w1, the two relative motions averaged
    elementwise as the reference does. The average is not rigid, so the
    result takes the general inverse, not `invert_se3`."""
    c2w1 = invert_se3(w2c_prev1)
    c2w2 = invert_se3(w2c_prev2)
    c2w3 = invert_se3(w2c_prev3)
    avg_rel = 0.5 * (c2w2 @ invert_se3(c2w3) + c2w1 @ invert_se3(c2w2))
    return torch.linalg.inv(avg_rel @ c2w1)
