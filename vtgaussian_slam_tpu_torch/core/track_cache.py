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
from ..ops.rasterizer.cuda_splat import (assemble_image, splat_blend,
                                         splat_forward)
from ..ops.rasterizer.projection import project_gaussians
from .losses import RenderResult


class TrackCache(NamedTuple):
    slots8: torch.Tensor   # (T, 8, mpt) [wx wy wz logit_op log_scale r g b]
    counts: torch.Tensor   # (T,) int32
    radii: torch.Tensor    # (N,) radii at the cache pose


def pad_bin_tables(tab: torch.Tensor, counts: torch.Tensor,
                   tile_pad: int = 0):
    """Pad (T, mpt) tables to a multiple of `tile_pad` rows (0: as they
    are; a tile-sharded group gives each rank whole blocks,
    parallel/engine.tile_pad_for). Padded rows carry count 0 and index-0
    slots, which no kernel renders."""
    T = tab.shape[0]
    Tp = -(-T // max(tile_pad, 1)) * max(tile_pad, 1)
    if Tp == T:
        return tab, counts
    return (torch.nn.functional.pad(tab, (0, 0, 0, Tp - T)),
            torch.nn.functional.pad(counts, (0, Tp - T)))


def fields8(params: GaussianParams) -> torch.Tensor:
    """(N, 8) field rows [wx wy wz logit_op log_scale r g b]."""
    return torch.cat([params.means3d, params.logit_opacities,
                      params.log_scales, params.rgb_colors], 1)


def project_at(params: GaussianParams, active: torch.Tensor,
               cam_quat: torch.Tensor, cam_trans: torch.Tensor, cam: Camera):
    """The isotropic Gaussians projected at a pose."""
    R = geo.quat_to_rotmat(geo.normalize(cam_quat))
    means_cam = params.means3d @ R.T + cam_trans
    return project_gaussians(means_cam, params.unnorm_rotations,
                             torch.exp(params.log_scales), params.opacities(),
                             cam, active)


@torch.no_grad()
def build_track_cache(params: GaussianParams, active: torch.Tensor,
                      cam_quat: torch.Tensor, cam_trans: torch.Tensor,
                      cam: Camera, *, tile: int = 16, span_cap: int = 3,
                      max_pairs_per_tile: int = 512, chunk: int = 128,
                      tile_pad: int = 0, select: str = "depth") -> TrackCache:
    """Bin once at the given pose and gather all per-slot fields; the
    tables pad to a multiple of `tile_pad` rows."""
    tiles_x = -(-cam.width // tile)
    tiles_y = -(-cam.height // tile)
    chunk = max(chunk, 128)
    mpt = -(-max_pairs_per_tile // chunk) * chunk
    proj = project_at(params, active, cam_quat, cam_trans, cam)
    b = bin_gaussians(proj, tile, span_cap, tiles_x, tiles_y, mpt,
                      select=select)
    tab, counts = pad_bin_tables(b.tab, b.counts, tile_pad)
    return TrackCache(slots8=gather_channels(fields8(params), tab),
                      counts=counts, radii=proj.radius)


def _pose_R9(cam_quat: torch.Tensor) -> torch.Tensor:
    return geo.quat_to_rotmat(geo.normalize(cam_quat)).reshape(9)


def render_cached(cache: TrackCache, cam_quat: torch.Tensor,
                  cam_trans: torch.Tensor, cam: Camera, tile: int = 16
                  ) -> RenderResult:
    """Render at a (slightly moved) pose from the frozen binning; the pose
    gradient comes from K2 through torch autograd."""
    tiles_x = -(-cam.width // tile)
    accum = splat_blend(cache.slots8, _pose_R9(cam_quat), cam_trans,
                        cache.counts, cam, tiles_x, grad_mode="pose")
    return accum_result(accum, cam, cache.radii, tile)


def accum_result(accum: torch.Tensor, cam: Camera, radii: torch.Tensor,
                 tile: int = 16) -> RenderResult:
    img = assemble_image(accum, cam, tile)
    return RenderResult(im=img[:3], depth=img[3:4], silhouette=img[4],
                        depth_sq=img[5:6], radii=radii)


@torch.no_grad()
def cached_harm(cache: TrackCache, cam_quat: torch.Tensor,
                cam_trans: torch.Tensor, cam: Camera) -> torch.Tensor:
    """Upper-bound truncation telemetry of one cached render (one K1): the
    share of tiles' pixels whose final transmittance stays >= 1/255 (K1's
    channel 6) on count-saturated tiles, i.e. where the dropped pair tail
    could have rendered. Loose: it cannot tell dropped mass from content
    that is not opaque; the engine steers by `map_cache.trunc_probe`."""
    tiles_x = -(-cam.width // 16)
    n_tiles = tiles_x * (-(-cam.height // 16))
    mpt = cache.slots8.shape[-1]
    accum = splat_forward(cache.slots8, _pose_R9(cam_quat), cam_trans,
                          cache.counts, cam, tiles_x)
    sat = (cache.counts[:n_tiles] >= mpt)[:, None]
    harmed = (accum[:n_tiles, 6, :] >= 1.0 / 255.0) & sat
    return harmed.float().mean()
