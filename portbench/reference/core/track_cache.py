"""Cached-binning tracking renderer.

Parity: `vtgaussian_slam_tpu/core/track_cache.py`. Within one tracked frame
the camera moves millimetres, so the binning is frozen at the phase's
initial pose: `build_track_cache` projects, bins and gathers every slot's
pose-independent fields once into the splat kernel's (T, 8, mpt) record
layout; `render_cached` is then one K1 launch per iteration, and its
backward one K2 launch that reduces (dR, dt) in-kernel. The quaternion
chain quat -> normalize -> R runs through torch autograd.

`build_track_cache_2c` bins in two classes (binning.bin_two_class): the
dense tiles keep the full pair budget, the rest a smaller one, and
`render_cached_2c` renders each class with its own K1 launch (the rows'
image tiles through K1's tile-id operand) and merges the rows; its
backward is one K2 launch per class, the two 12-float sums added.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.gaussians import GaussianParams
from ..ops import geometry as geo
from ..ops.camera import Camera
from ..ops.rasterizer.binning import (bin_gaussians, bin_two_class,
                                      gather_channels)
from ..ops.rasterizer.cuda_splat import (assemble_image, splat_backward_pose,
                                         splat_blend, splat_forward)
from ..ops.rasterizer.projection import project_gaussians
from .losses import RenderResult


class TrackCache(NamedTuple):
    slots8: torch.Tensor   # (T, 8, mpt) [wx wy wz logit_op log_scale r g b]
    counts: torch.Tensor   # (T,) int32
    radii: torch.Tensor    # (N,) radii at the cache pose


class TrackCache2C(NamedTuple):
    """Two-class frozen tracking binning: two slot tables, the image tile
    of each row, and the row merge back to the image's tiles."""
    slots_d: torch.Tensor   # (Kp, 8, mpt_d)
    counts_d: torch.Tensor  # (Kp,) int32
    tids_d: torch.Tensor    # (Kp,) int32 image tile per dense row
    slots_s: torch.Tensor   # (Sp, 8, mpt_s)
    counts_s: torch.Tensor  # (Sp,)
    tids_s: torch.Tensor    # (Sp,)
    merge: torch.Tensor     # (n_tiles,) row into [accum_d; accum_s]
    radii: torch.Tensor     # (N,)


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


@torch.no_grad()
def build_track_cache_2c(params: GaussianParams, active: torch.Tensor,
                         cam_quat: torch.Tensor, cam_trans: torch.Tensor,
                         cam: Camera, *, tile: int = 16, span_cap: int = 3,
                         max_pairs_per_tile: int = 512, mpt_sparse: int = 128,
                         k_dense: int = 64, select: str = "depth"
                         ) -> TrackCache2C:
    """`build_track_cache` with two-class binning: the k_dense fullest tiles
    at max_pairs_per_tile, the rest at mpt_sparse (both rounded up to 128)."""
    tiles_x = -(-cam.width // tile)
    tiles_y = -(-cam.height // tile)
    mpt = -(-max_pairs_per_tile // 128) * 128
    mpt_s = -(-mpt_sparse // 128) * 128
    proj = project_at(params, active, cam_quat, cam_trans, cam)
    b = bin_two_class(proj, tile, span_cap, tiles_x, tiles_y, mpt, mpt_s,
                      k_dense, select=select)
    f8 = fields8(params)
    return TrackCache2C(slots_d=gather_channels(f8, b.tab_d),
                        counts_d=b.counts_d, tids_d=b.tids_d,
                        slots_s=gather_channels(f8, b.tab_s),
                        counts_s=b.counts_s, tids_s=b.tids_s,
                        merge=b.merge, radii=proj.radius)


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


class SplatPose2C(torch.autograd.Function):
    """K1 over each class (its rows' image tiles through the tile-id
    operand), merged to (n_tiles, 8, 256) by one row gather. Backward: K2
    per class on the cotangent rows of its tiles, g[tids] (a padded row's
    tid 0 points at a real tile's row, and its count 0 makes K2 give zeros
    there), the two (dR, dt) sums added."""

    @staticmethod
    def forward(ctx, R9, trans, cache, cam, tiles_x):
        accs = [splat_forward(slots, R9.detach(), trans.detach(), counts, cam,
                              tiles_x, tids)
                for slots, counts, tids in _classes(cache)]
        ctx.save_for_backward(R9.detach(), trans.detach(), *accs)
        ctx.cache, ctx.cam, ctx.tiles_x = cache, cam, tiles_x
        return torch.cat(accs)[cache.merge]

    @staticmethod
    def backward(ctx, g):
        R9, trans, *accs = ctx.saved_tensors
        tot = 0
        for (slots, counts, tids), acc in zip(_classes(ctx.cache), accs):
            tot = tot + splat_backward_pose(
                slots, R9, trans, counts, acc, g[tids.long()], ctx.cam,
                ctx.tiles_x, tids).sum(0)
        return tot[:9], tot[9:12], None, None, None


def _classes(cache: TrackCache2C):
    return ((cache.slots_d, cache.counts_d, cache.tids_d),
            (cache.slots_s, cache.counts_s, cache.tids_s))


def splat_pose_2c(R9: torch.Tensor, trans: torch.Tensor, cache: TrackCache2C,
                  cam: Camera, tiles_x: int) -> torch.Tensor:
    """The merged (n_tiles, 8, 256) accum of a two-class cache at a pose,
    differentiable in (R9, trans)."""
    return SplatPose2C.apply(R9, trans, cache, cam, tiles_x)


def render_cached_2c(cache: TrackCache2C, cam_quat: torch.Tensor,
                     cam_trans: torch.Tensor, cam: Camera, tile: int = 16
                     ) -> RenderResult:
    """`render_cached` over a two-class cache: two K1 launches per
    iteration, two K2 launches per backward."""
    tiles_x = -(-cam.width // tile)
    accum = splat_pose_2c(_pose_R9(cam_quat), cam_trans, cache, cam, tiles_x)
    return accum_result(accum, cam, cache.radii, tile)


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
