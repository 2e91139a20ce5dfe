"""Point-to-plane candidate metric for boundary tracking.

Parity: `vtgaussian_slam_tpu/core/p2p.py`. The target frame (fixed while a
frame is tracked) is back-projected with factor 1 and given
finite-difference normals, both in world coordinates, packed one 32-byte
row per pixel. Each source point at the current pose iterate is associated
projectively: projected into the target camera, it takes the target row of
the pixel it falls in (floor, the exact inverse of the +0.5 ray). Pairs
farther apart than 0.02 m, or outside either camera's frustum, drop out.
The metric steers candidate selection only and carries no gradient.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import geometry as geo


class P2PTarget(NamedTuple):
    packed: torch.Tensor      # (H*W, 8) rows [pt_world(3) normal_world(3) valid 0]
    w2c: torch.Tensor         # (4, 4)
    intrinsics: torch.Tensor  # (3, 3)
    height: int
    width: int


@torch.no_grad()
def make_p2p_target(depth: torch.Tensor, intrinsics: torch.Tensor,
                    w2c: torch.Tensor) -> P2PTarget:
    """The target frame's geometry, once per tracked frame."""
    d = depth[0] if depth.dim() == 3 else depth
    H, W = d.shape
    c2w = geo.invert_se3(w2c)
    pts = geo.backproject(d, intrinsics, c2w=c2w, depth_factor=1.0)
    normals = geo.depth_to_normals(d, intrinsics).reshape(-1, 3) @ c2w[:3, :3].T
    valid = (d > 0).reshape(-1, 1).to(pts.dtype)
    packed = torch.cat([pts, normals, valid, torch.zeros_like(valid)], 1)
    return P2PTarget(packed=packed, w2c=w2c, intrinsics=intrinsics, height=H,
                     width=W)


@torch.no_grad()
def point2plane_metric(target: P2PTarget, src_depth: torch.Tensor,
                       src_intrinsics: torch.Tensor, src_w2c: torch.Tensor,
                       method: str = "sum", dist_thres: float = 0.02
                       ) -> torch.Tensor:
    """sum((n . dp)^2) ("sum"), max |n . dp| ("max") or the mean of the 100
    largest |n . dp| over min(max(pairs, 1), 100) ("max100") over the
    surviving pairs; +inf when no pair survives (a vacuous 0 would beat
    every real pose)."""
    d = src_depth[0] if src_depth.dim() == 3 else src_depth
    H, W = d.shape
    src_pts = geo.backproject(d, src_intrinsics, c2w=geo.invert_se3(src_w2c),
                              depth_factor=1.0)
    src_valid = (d > 0).reshape(-1)
    src_in_tgt = geo.frustum_mask(target.w2c, target.intrinsics, src_pts,
                                  target.height, target.width)
    uv, z = geo.project_points(geo.transform_points(target.w2c, src_pts),
                               target.intrinsics)
    px = torch.floor(uv[:, 0]).to(torch.int64)
    py = torch.floor(uv[:, 1]).to(torch.int64)
    inb = (px >= 0) & (px < target.width) & (py >= 0) & (py < target.height)
    pix = (torch.clamp(py, 0, target.height - 1) * target.width
           + torch.clamp(px, 0, target.width - 1))
    rows = target.packed[pix]
    tgt_pt, tgt_n = rows[:, 0:3], rows[:, 3:6]
    # the target -> source cull on the gathered rows equals culling the
    # whole target set and gathering the flag
    tgt_ok = (rows[:, 6] > 0) & geo.frustum_mask(src_w2c, src_intrinsics,
                                                  tgt_pt, H, W)
    dp = src_pts - tgt_pt
    pair = (src_valid & src_in_tgt & inb & tgt_ok
            & ((dp * dp).sum(-1) < dist_thres * dist_thres) & (z > 0))
    resid = torch.where(pair, (tgt_n * dp).sum(-1), torch.zeros_like(z))
    n_pairs = pair.sum()
    if method == "sum":
        m = (resid * resid).sum()
    elif method == "max":
        m = resid.abs().max()
    elif method == "max100":
        top = torch.topk(resid.abs(), min(100, resid.numel())).values
        m = top.sum() / torch.clamp(torch.clamp(n_pairs, min=1), max=100)
    else:
        raise ValueError(f"unknown p2p method {method!r}")
    return torch.where(n_pairs > 0, m, torch.full_like(m, float("inf")))
