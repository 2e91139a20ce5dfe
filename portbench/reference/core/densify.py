"""Silhouette-driven densification (new-Gaussian insertion).

Parity: `vtgaussian_slam_tpu/core/densify.py`:
  non_presence = (silhouette < sil_thres)
               | ((render_depth > gt) & (depth_err > 50 * median(depth_err)))
computed on a FRESH full render at the committed pose (rendering through the
tracking cache instead un-covers a band of every tile once the pose moved a
few pixels, and densification then re-adds mapped geometry every frame).
Candidate pixels are compacted on the host; `densify_from_pixels`
back-projects them (+0.5 pixel centre, x1.005 depth, projective
mean-square-distance scale).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.gaussians import GaussianParams
from ..ops import geometry as geo
from ..ops.camera import Camera
from .losses import Frame, lower_median, render_slam


class DensifyCandidates(NamedTuple):
    points: torch.Tensor         # (M, 3) world
    colors: torch.Tensor         # (M, 3)
    mean3_sq_dist: torch.Tensor  # (M,)
    keep: torch.Tensor           # (M,) bool


@torch.no_grad()
def densify_nonpresence(params: GaussianParams, active: torch.Tensor,
                        cam_quat: torch.Tensor, cam_trans: torch.Tensor,
                        frame: Frame, cam: Camera, sil_thres: float,
                        backend_kwargs: tuple = ()) -> torch.Tensor:
    """The (H, W) non-presence mask from a fresh render (K4)."""
    r = render_slam(params, active, cam_quat, cam_trans, cam,
                    dict(backend_kwargs))
    gt_depth = frame.depth[0]
    render_depth = r.depth[0]
    depth_err = (gt_depth - render_depth).abs() * (gt_depth > 0)
    med = lower_median(depth_err)
    return (r.silhouette < sil_thres) | (
        (render_depth > gt_depth) & (depth_err > 50 * med))


@torch.no_grad()
def densify_from_pixels(cam_quat: torch.Tensor, cam_trans: torch.Tensor,
                        depth_vals: torch.Tensor, colors: torch.Tensor,
                        idx: torch.Tensor, valid: torch.Tensor,
                        cam: Camera) -> DensifyCandidates:
    """Back-project compacted candidate pixels (flat indices `idx`) at the
    committed pose."""
    fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
    rows = torch.div(idx, cam.width, rounding_mode="floor").float()
    cols = (idx % cam.width).float()
    z = depth_vals * 1.005
    pts_cam = torch.stack([(cols - cx + 0.5) / fx * z,
                           (rows - cy + 0.5) / fy * z, z], -1)
    w2c = geo.pose_to_w2c(geo.normalize(cam_quat), cam_trans)
    pts = geo.transform_points(geo.invert_se3(w2c), pts_cam)
    msq = geo.mean_sq_dist_projective(depth_vals, fx, fy)
    return DensifyCandidates(points=pts, colors=colors, mean3_sq_dist=msq,
                             keep=valid & (depth_vals > 0))


@torch.no_grad()
def first_frame_pointcloud(frame: Frame, cam: Camera,
                           mask: torch.Tensor | None = None):
    """Full-frame back-projection for the first frame's section (camera
    frame == world frame). Returns (points, colors, mean_sq_dist, keep)."""
    gt_depth = frame.depth[0]
    keep = gt_depth > 0
    if mask is not None:
        keep = keep & mask
    K = torch.as_tensor(cam.intrinsics, device=gt_depth.device)
    pts = geo.backproject(gt_depth, K)
    msq = geo.mean_sq_dist_projective(gt_depth.reshape(-1), K[0, 0], K[1, 1])
    colors = frame.color.reshape(3, -1).T
    return pts, colors, msq, keep.reshape(-1)


@torch.no_grad()
def base_frame_pointcloud(frame: Frame, cam: Camera, w2c: torch.Tensor,
                          mask: torch.Tensor | None = None):
    """Full-frame back-projection at a tracked pose, for the section a
    boundary frame spawns. Returns (points, colors, mean_sq_dist, keep)."""
    gt_depth = frame.depth[0]
    keep = gt_depth > 0
    if mask is not None:
        keep = keep & mask
    K = torch.as_tensor(cam.intrinsics, device=gt_depth.device)
    pts = geo.backproject(gt_depth, K, c2w=geo.invert_se3(w2c))
    msq = geo.mean_sq_dist_projective(gt_depth.reshape(-1), K[0, 0], K[1, 1])
    colors = frame.color.reshape(3, -1).T
    return pts, colors, msq, keep.reshape(-1)
