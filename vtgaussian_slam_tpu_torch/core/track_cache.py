"""Cached-binning tracking renderer.

Parity: `vtgaussian_slam_tpu/core/track_cache.py`. Within one tracked frame
the camera moves millimetres, so the binning is frozen at the phase's
initial pose: `build_track_cache` projects, bins and gathers every slot's
pose-independent fields once into the splat kernel's (T, 8, mpt) record
layout; `render_cached` is then one K1 launch per iteration, and its
backward one K2 launch that reduces (dR, dt) in-kernel. The quaternion
chain quat -> normalize -> R runs through torch autograd.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.gaussians import GaussianParams
from ..ops import geometry as geo
from ..ops.camera import Camera
from ..ops.rasterizer.binning import bin_gaussians, gather_channels
from ..ops.rasterizer.cuda_splat import assemble_image, splat_blend
from ..ops.rasterizer.projection import project_gaussians
from .losses import RenderResult


class TrackCache(NamedTuple):
    slots8: torch.Tensor   # (T, 8, mpt) [wx wy wz logit_op log_scale r g b]
    counts: torch.Tensor   # (T,) int32
    radii: torch.Tensor    # (N,) radii at the cache pose


def fields8(params: GaussianParams) -> torch.Tensor:
    """(N, 8) field rows [wx wy wz logit_op log_scale r g b]."""
    return torch.cat([params.means3d, params.logit_opacities,
                      params.log_scales, params.rgb_colors], 1)


@torch.no_grad()
def build_track_cache(params: GaussianParams, active: torch.Tensor,
                      cam_quat: torch.Tensor, cam_trans: torch.Tensor,
                      cam: Camera, *, tile: int = 16, span_cap: int = 3,
                      max_pairs_per_tile: int = 512, chunk: int = 128,
                      select: str = "depth") -> TrackCache:
    """Bin once at the given pose and gather all per-slot fields."""
    tiles_x = -(-cam.width // tile)
    tiles_y = -(-cam.height // tile)
    chunk = max(chunk, 128)
    mpt = -(-max_pairs_per_tile // chunk) * chunk
    R = geo.quat_to_rotmat(geo.normalize(cam_quat))
    means_cam = params.means3d @ R.T + cam_trans
    proj = project_gaussians(means_cam, params.unnorm_rotations,
                             torch.exp(params.log_scales), params.opacities(),
                             cam, active)
    b = bin_gaussians(proj, tile, span_cap, tiles_x, tiles_y, mpt,
                      select=select)
    return TrackCache(slots8=gather_channels(fields8(params), b.tab),
                      counts=b.counts, radii=proj.radius)


def render_cached(cache: TrackCache, cam_quat: torch.Tensor,
                  cam_trans: torch.Tensor, cam: Camera, tile: int = 16
                  ) -> RenderResult:
    """Render at a (slightly moved) pose from the frozen binning; the pose
    gradient comes from K2 through torch autograd."""
    tiles_x = -(-cam.width // tile)
    R = geo.quat_to_rotmat(geo.normalize(cam_quat))
    accum = splat_blend(cache.slots8, R.reshape(9), cam_trans, cache.counts,
                        cam, tiles_x, grad_mode="pose")
    img = assemble_image(accum, cam, tile)
    return RenderResult(im=img[:3], depth=img[3:4], silhouette=img[4],
                        depth_sq=img[5:6], radii=cache.radii)
