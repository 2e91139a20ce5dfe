"""RGB-D visual odometry: multi-scale point-to-plane (and hybrid)
Gauss-Newton, the ScanNet++ tracking rescue's pose initializer.

Parity: `vtgaussian_slam_tpu/core/odometry.py`. A 3-level pyramid (2x2
means over valid depths, box-filtered intensity), projective data
association of the warped previous frame into the current one, and per
level a fixed number of Gauss-Newton steps on an se(3) twist: the point-to-
plane residual, plus in the hybrid form half the weight of a photometric
residual through the current frame's intensity gradients. Each 6x6 system
is damped relative to its trace, solved in float32 (`torch.linalg.solve`;
its rounding differs from `jnp.linalg.solve`'s, so the recovered pose
agrees with the JAX package's to a tolerance, not to the bit) and its step
clamped to 0.05 rad / 0.05 m. Runs as PyTorch ops on the frames' device.

`VisualOdometer.estimate_rel_pose` returns M with x_prev = M @ x_curr, the
relative c2w that the engine composes as init_c2w = c2w_prev @ M.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import geometry as geo


def _skew(k: torch.Tensor) -> torch.Tensor:
    z = torch.zeros((), dtype=k.dtype, device=k.device)
    return torch.stack([torch.stack([z, -k[2], k[1]]),
                        torch.stack([k[2], z, -k[0]]),
                        torch.stack([-k[1], k[0], z])])


def _se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """xi = [omega(3), t(3)] -> 4x4, with the full SO(3) exponential and
    its V matrix."""
    w, t = xi[:3], xi[3:]
    th = torch.linalg.norm(w) + 1e-12
    K = _skew(w / th)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    KK = K @ K
    R = eye + torch.sin(th) * K + (1 - torch.cos(th)) * KK
    V = eye + (1 - torch.cos(th)) / th * K + (th - torch.sin(th)) / th * KK
    T = torch.eye(4, dtype=xi.dtype, device=xi.device)
    T[:3, :3] = R
    T[:3, 3] = V @ t
    return T


def _downsample(depth: torch.Tensor, color: torch.Tensor):
    """One 2x pyramid level: 2x2 mean over valid depths, box-filtered
    intensity."""
    H, W = depth.shape
    d = depth[:H // 2 * 2, :W // 2 * 2].reshape(H // 2, 2, W // 2, 2)
    m = (d > 0).to(depth.dtype)
    dsum = (d * m).sum((1, 3))
    dcnt = m.sum((1, 3))
    d2 = torch.where(dcnt > 0, dsum / torch.clamp(dcnt, min=1),
                     torch.zeros_like(dsum))
    c = color[:H // 2 * 2, :W // 2 * 2].reshape(H // 2, 2, W // 2, 2)
    return d2, c.mean((1, 3))


@torch.no_grad()
def rgbd_odometry_multi_scale(src_depth: torch.Tensor, src_gray: torch.Tensor,
                              dst_depth: torch.Tensor, dst_gray: torch.Tensor,
                              intrinsics: torch.Tensor,
                              init_T: torch.Tensor | None = None,
                              iters: int = 10, levels: int = 3,
                              hybrid: bool = False, max_depth: float = 10.0,
                              dist_thres: float = 0.07) -> torch.Tensor:
    """T with x_dst = T @ x_src (source = the previous frame, target = the
    current one); depths (H, W) in metres, intensities (H, W) in [0, 1]."""
    pyr = [(src_depth, src_gray, dst_depth, dst_gray, intrinsics)]
    for _ in range(levels - 1):
        sd, sg, dd, dg, K = pyr[-1]
        sd2, sg2 = _downsample(sd, sg)
        dd2, dg2 = _downsample(dd, dg)
        K2 = K.clone()
        K2[:2] = K2[:2] * 0.5
        pyr.append((sd2, sg2, dd2, dg2, K2))

    dev, dt = src_depth.device, src_depth.dtype
    T = (torch.eye(4, dtype=dt, device=dev) if init_T is None
         else init_T.to(device=dev, dtype=dt))
    eye6 = torch.eye(6, dtype=dt, device=dev)
    for sd, sg, dd, dg, K in reversed(pyr):
        H, W = sd.shape
        dst_pts = geo.backproject(dd, K, depth_factor=1.0,
                                  pixel_center=0.0).reshape(H, W, 3)
        dst_n = geo.depth_to_normals(dd, K)
        src_pts = geo.backproject(sd, K, depth_factor=1.0,
                                  pixel_center=0.0).reshape(-1, 3)
        src_valid = ((sd > 0) & (sd < max_depth)).reshape(-1)
        sg_flat = sg.reshape(-1)
        fx, fy = K[0, 0], K[1, 1]
        for _ in range(iters):
            warped = geo.transform_points(T, src_pts)
            uv, z = geo.project_points(warped, K)
            px = torch.round(uv[:, 0]).to(torch.int64)
            py = torch.round(uv[:, 1]).to(torch.int64)
            inb = (px >= 0) & (px < W) & (py >= 0) & (py < H) & (z > 0)
            pxc = torch.clamp(px, 0, W - 1)
            pyc = torch.clamp(py, 0, H - 1)
            V = dst_pts[pyc, pxc]
            N = dst_n[pyc, pxc]
            dv = dd[pyc, pxc]
            dvalid = (dv > 0) & (dv < max_depth)
            dp = warped - V
            ok = (src_valid & inb & dvalid
                  & ((dp * dp).sum(-1) < dist_thres * dist_thres))
            # zero the residual and the jacobian of invalid rows: a depth
            # hole back-projects to inf, and inf * 0 would be NaN
            zero = torch.zeros((), dtype=dt, device=dev)
            r = torch.where(ok, (N * dp).sum(-1), zero)
            Jw = torch.linalg.cross(warped, N, dim=-1)
            J = torch.where(ok[:, None], torch.cat([Jw, N], -1), zero)
            JTJ = J.T @ J
            JTr = J.T @ r
            if hybrid:
                gval = dg[pyc, pxc]
                gr = torch.where(ok, gval - sg_flat, zero)
                gx = (dg[pyc, torch.clamp(pxc + 1, 0, W - 1)]
                      - dg[pyc, torch.clamp(pxc - 1, 0, W - 1)]) * 0.5
                gy = (dg[torch.clamp(pyc + 1, 0, H - 1), pxc]
                      - dg[torch.clamp(pyc - 1, 0, H - 1), pxc]) * 0.5
                zs = torch.clamp(z, min=1e-6)
                jx = torch.stack([gx * fx / zs, gy * fy / zs,
                                  -(gx * fx * warped[:, 0]
                                    + gy * fy * warped[:, 1]) / (zs * zs)], -1)
                Jp = torch.where(
                    ok[:, None],
                    torch.cat([torch.linalg.cross(warped, jx, dim=-1), jx], -1),
                    zero)
                JTJ = JTJ + 0.5 * (Jp.T @ Jp)
                JTr = JTr + 0.5 * (Jp.T @ gr)
            # Levenberg damping relative to the problem's scale and a
            # trust-region clamp: pure point-to-plane is rank-deficient on
            # dominant planes (a sliding direction)
            lam = 1e-4 * torch.trace(JTJ) / 6.0 + 1e-8
            delta = torch.linalg.solve(JTJ + lam * eye6, -JTr)
            delta = torch.where(torch.isfinite(delta).all(), delta,
                                torch.zeros_like(delta))
            rot_n = torch.linalg.norm(delta[:3])
            tr_n = torch.linalg.norm(delta[3:])
            scale = torch.clamp(torch.minimum(
                0.05 / torch.clamp(rot_n, min=1e-12),
                0.05 / torch.clamp(tr_n, min=1e-12)), max=1.0)
            T = _se3_exp(delta * scale) @ T
    return T


class VisualOdometer:
    """The reference's VisualOdometer API over `rgbd_odometry_multi_scale`,
    on `device` (CUDA unless the caller passes "cpu")."""

    def __init__(self, intrinsics, method_name: str = "hybrid",
                 device="cuda"):
        from ..utils.common import resolve_device
        if method_name not in ("hybrid", "point_to_plane"):
            raise ValueError("Odometry method does not exist!")
        self.device = resolve_device(device)
        self.intrinsics = torch.as_tensor(
            np.asarray(intrinsics, np.float32)[:3, :3], device=self.device)
        self.hybrid = method_name == "hybrid"
        self.last_rgbd = None
        self.max_depth = 10.0

    def _gray(self, image) -> torch.Tensor:
        # scale by dtype (uint8 -> /255), not by a per-frame heuristic, so
        # that a nearly black 0-255 frame stays on the same scale
        img = np.asarray(image)
        f = img.astype(np.float32)
        if img.dtype == np.uint8 or f.max() > 1.001:
            f = f / 255.0
        return torch.as_tensor(f @ np.array([0.299, 0.587, 0.114], np.float32),
                               device=self.device)

    def _depth(self, depth) -> torch.Tensor:
        if isinstance(depth, torch.Tensor):
            d = depth.to(device=self.device, dtype=torch.float32)
        else:
            d = torch.as_tensor(np.asarray(depth, np.float32),
                                device=self.device)
        return d[..., 0] if d.dim() == 3 else d

    def update_last_rgbd(self, image, depth) -> None:
        self.last_rgbd = (self._depth(depth), self._gray(image))

    def estimate_rel_pose(self, image, depth, init_transform=None
                          ) -> np.ndarray:
        curr = (self._depth(depth), self._gray(image))
        T = rgbd_odometry_multi_scale(
            self.last_rgbd[0], self.last_rgbd[1], curr[0], curr[1],
            self.intrinsics,
            None if init_transform is None else torch.as_tensor(
                np.asarray(init_transform, np.float32), device=self.device),
            hybrid=self.hybrid, max_depth=self.max_depth)
        self.last_rgbd = curr
        # T maps previous-frame coordinates to the current frame's; the
        # pose initializer wants the current c2w relative to the previous
        return geo.invert_se3(T).cpu().numpy()
