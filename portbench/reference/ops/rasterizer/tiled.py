"""Tile-binned renderer over the record-space blend kernels (K4, K5).

Parity: `vtgaussian_slam_tpu/ops/rasterizer/tiled.py:render_tiled`, its
Pallas route: project, bin (depth order), gather one 16-row record per
slot, blend per tile. The render is differentiable: `BlendGather` gathers
the records and runs K4 forward; its backward runs K5 and maps the
per-record gradients back onto the N record rows through the binning's
inverse map (`apply_slot_inverse`, the exact transpose of the gather, with
no float atomics), and autograd carries them on through the projection.
Binning stays gradient-free: integer tables act as stop-gradient, as in
JAX. A render under `torch.no_grad` (densify, eval) skips the inverse map.
"""
from __future__ import annotations

import torch

from ..camera import Camera
from .binning import (SlotInv, apply_slot_inverse, bin_gaussians,
                      gather_channels, slot_inverse)
from .cuda_blend import RECW, TILE, blend_backward, blend_forward
from .projection import project_gaussians

BLEND_CHANNELS = 8   # colour rows per record the blend composites


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _binned_sources(means_cam, quats, scales, opacities, colors, cam, active,
                    tile, span_cap, max_pairs_per_tile, chunk, with_inverse):
    """Project, bin, and build the (N, 16) record rows [mean2d(2) conic(3)
    opacity colors(C) 0...] the slots gather from."""
    if tile != TILE:
        raise ValueError(f"the blend takes {TILE}-pixel tiles")
    N, C = colors.shape
    if C > BLEND_CHANNELS:
        raise ValueError(f"the blend takes up to {BLEND_CHANNELS} channels")
    tiles_x = _cdiv(cam.width, tile)
    tiles_y = _cdiv(cam.height, tile)
    chunk = max(chunk, 128)
    mpt = _cdiv(max_pairs_per_tile, chunk) * chunk

    proj = project_gaussians(means_cam, quats, scales, opacities, cam, active)
    binned = bin_gaussians(proj, tile, span_cap, tiles_x, tiles_y, mpt,
                           with_inverse=with_inverse)
    rec_src = torch.cat(
        [proj.mean2d, proj.conic, proj.opacity[:, None], colors,
         colors.new_zeros((N, RECW - 6 - C))], 1)
    return rec_src, binned, proj.radius


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
    rec_src, binned, radii = _binned_sources(
        means_cam, quats, scales, opacities, colors, cam, active, tile,
        span_cap, max_pairs_per_tile, chunk, False)
    return gather_channels(rec_src, binned.tab), binned.counts, radii


class BlendGather(torch.autograd.Function):
    """rec_src (N, 16) -> slot gather through `tab` -> K4 -> (T, 256, 8).
    Backward: K5 rows (T, mpt, 16) -> inverse-map gather -> d rec_src."""

    @staticmethod
    def forward(ctx, rec_src, tab, counts, inv_pos, inv_w, tiles_x):
        recs = gather_channels(rec_src, tab)
        out = blend_forward(recs, counts, tiles_x, BLEND_CHANNELS)
        ctx.save_for_backward(recs, counts, out, inv_pos, inv_w)
        ctx.tiles_x = tiles_x
        return out

    @staticmethod
    def backward(ctx, g):
        recs, counts, out, inv_pos, inv_w = ctx.saved_tensors
        rows = blend_backward(recs, counts, out, g, ctx.tiles_x)
        g_src = apply_slot_inverse(rows.reshape(-1, RECW),
                                   SlotInv(inv_pos, inv_w))
        return g_src, None, None, None, None, None


def blend_image(accum: torch.Tensor, cam: Camera, n_channels: int
                ) -> torch.Tensor:
    """(T, 256, 8) blend output -> (n_channels, H, W) image."""
    tiles_x = _cdiv(cam.width, TILE)
    tiles_y = _cdiv(cam.height, TILE)
    img = accum[..., :n_channels].reshape(tiles_y, tiles_x, TILE, TILE,
                                          n_channels)
    img = img.permute(4, 0, 2, 1, 3).reshape(n_channels, tiles_y * TILE,
                                             tiles_x * TILE)
    return img[:, :cam.height, :cam.width]


def render_tiled(means_cam: torch.Tensor, quats: torch.Tensor,
                 scales: torch.Tensor, opacities: torch.Tensor,
                 colors: torch.Tensor, cam: Camera,
                 active: torch.Tensor | None = None, *, tile: int = TILE,
                 span_cap: int = 3, max_pairs_per_tile: int = 1024,
                 chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """Render a (C, H, W) image and per-Gaussian radii (N,), differentiable
    in every float input."""
    need_grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in (means_cam, quats, scales, opacities, colors))
    rec_src, binned, radii = _binned_sources(
        means_cam, quats, scales, opacities, colors, cam, active, tile,
        span_cap, max_pairs_per_tile, chunk, need_grad)
    tiles_x = _cdiv(cam.width, tile)
    if need_grad:
        inv = slot_inverse(binned.inv_pos)
        accum = BlendGather.apply(rec_src, binned.tab, binned.counts, inv.pos,
                                  inv.w, tiles_x)
    else:
        accum = blend_forward(gather_channels(rec_src, binned.tab),
                              binned.counts, tiles_x, BLEND_CHANNELS)
    return blend_image(accum, cam, colors.shape[1]), radii
