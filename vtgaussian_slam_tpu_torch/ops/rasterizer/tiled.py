"""Tile-binned renderer over the record-space blend kernel (K4).

Parity: `vtgaussian_slam_tpu/ops/rasterizer/tiled.py:render_tiled`, its
Pallas route: project, bin (depth order), gather one 16-row record per
slot, blend per tile. Forward only: on this slice's path the renderer feeds
densification and evaluation, which take no gradient; the generic
differentiable route (blend backward K5) waits for a later slice.
"""
from __future__ import annotations

import torch

from ..camera import Camera
from . import _build
from .binning import bin_gaussians
from .cuda_blend import RECW, TILE, blend_forward
from .projection import project_gaussians

BLEND_CHANNELS = 8   # colour rows per record the blend composites


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@torch.no_grad()
def tile_records(means_cam: torch.Tensor, quats: torch.Tensor,
                 scales: torch.Tensor, opacities: torch.Tensor,
                 colors: torch.Tensor, cam: Camera,
                 active: torch.Tensor | None = None, *, tile: int = TILE,
                 span_cap: int = 3, max_pairs_per_tile: int = 1024,
                 chunk: int = 128
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The blend's inputs: records (T, 16, mpt) rows [mean2d(2) conic(3)
    opacity colors(C) 0...], depth-ordered per tile, their counts (T,), and
    per-Gaussian radii (N,)."""
    _build.require(tile == TILE, f"the blend kernel takes {TILE}-pixel tiles")
    N, C = colors.shape
    _build.require(C <= BLEND_CHANNELS,
                   f"the blend kernel takes up to {BLEND_CHANNELS} channels")
    tiles_x = _cdiv(cam.width, tile)
    tiles_y = _cdiv(cam.height, tile)
    chunk = max(chunk, 128)
    mpt = _cdiv(max_pairs_per_tile, chunk) * chunk

    proj = project_gaussians(means_cam, quats, scales, opacities, cam, active)
    binned = bin_gaussians(proj, tile, span_cap, tiles_x, tiles_y, mpt)
    rec_src = torch.cat(
        [proj.mean2d, proj.conic, proj.opacity[:, None], colors,
         colors.new_zeros((N, RECW - 6 - C))], 1)
    recs = rec_src[binned.tab].transpose(1, 2).contiguous()   # (T, 16, mpt)
    return recs, binned.counts, proj.radius


def blend_records(recs: torch.Tensor, counts: torch.Tensor, cam: Camera,
                  n_channels: int) -> torch.Tensor:
    """K4 over `tile_records` output -> (n_channels, H, W) image."""
    tiles_x = _cdiv(cam.width, TILE)
    tiles_y = _cdiv(cam.height, TILE)
    accum = blend_forward(recs, counts, tiles_x, BLEND_CHANNELS)
    img = accum[..., :n_channels].reshape(tiles_y, tiles_x, TILE, TILE,
                                          n_channels)
    img = img.permute(4, 0, 2, 1, 3).reshape(n_channels, tiles_y * TILE,
                                             tiles_x * TILE)
    return img[:, :cam.height, :cam.width]


@torch.no_grad()
def render_tiled(means_cam: torch.Tensor, quats: torch.Tensor,
                 scales: torch.Tensor, opacities: torch.Tensor,
                 colors: torch.Tensor, cam: Camera,
                 active: torch.Tensor | None = None, **kw
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Render a (C, H, W) image and per-Gaussian radii (N,); `kw` are
    `tile_records`' keywords."""
    recs, counts, radii = tile_records(means_cam, quats, scales, opacities,
                                       colors, cam, active, **kw)
    return blend_records(recs, counts, cam, colors.shape[1]), radii
