"""Tile-sharded rendering and one-step optimisers over `torch.distributed`.

Parity: `vtgaussian_slam_tpu/parallel/sharded.py`. The JAX package shards
`render_tiled`'s compositing scan over image tiles with GSPMD; here each
rank projects and bins the Gaussians (replicated: O(N) and a sort), runs
K4 on its contiguous range of tile rows at its tile offset, and the ranks'
rows are all-gathered into the full image. The backward runs K5 on the
rank's rows, all-gathers the per-record gradient rows and maps them onto
the Gaussians through the whole inverse map, as `tiled.BlendGather` does:
every rank holds the single-card gradient, to the bit
(parallel/engine.py says why the rows and not partial sums).
"""
from __future__ import annotations

import torch

from ..core.losses import _slam_inputs
from ..core.track_cache import pad_bin_tables
from ..models.gaussians import GaussianParams
from ..ops.camera import Camera
from ..ops.rasterizer.binning import (SlotInv, apply_slot_inverse,
                                      gather_channels, slot_inverse)
from ..ops.rasterizer.cuda_blend import RECW, blend_backward, blend_forward
from ..ops.rasterizer.tiled import BLEND_CHANNELS, _binned_sources, blend_image
from .engine import TileGroup, all_gather_rows, shard_rows


class BlendGatherSharded(torch.autograd.Function):
    """`tiled.BlendGather` on this rank's rows of `tab` (record gather, K4
    at the rank's tile offset), the outputs gathered. Backward: K5 on the
    rank's rows, the (Tp, mpt, 16) record rows gathered and mapped through
    the inverse map as `BlendGather` maps them."""

    @staticmethod
    def forward(ctx, rec_src, tab, counts, inv_pos, inv_w, tiles_x, group):
        lo, Tl = shard_rows(tab.shape[0], group)
        recs = gather_channels(rec_src, tab[lo:lo + Tl])
        out = blend_forward(recs, counts[lo:lo + Tl], tiles_x, BLEND_CHANNELS,
                            tile_offset=lo)
        ctx.save_for_backward(recs, out, inv_pos, inv_w)
        ctx.args = (counts[lo:lo + Tl], tiles_x, lo, Tl, group)
        return all_gather_rows(out, group)

    @staticmethod
    def backward(ctx, g):
        recs, out, inv_pos, inv_w = ctx.saved_tensors
        counts, tiles_x, lo, Tl, group = ctx.args
        rows = blend_backward(recs, counts, out, g[lo:lo + Tl], tiles_x,
                              tile_offset=lo)
        flat = all_gather_rows(rows, group).reshape(-1, RECW)
        g_src = apply_slot_inverse(flat, SlotInv(inv_pos, inv_w))
        return g_src, None, None, None, None, None, None


def sharded_render(means_cam: torch.Tensor, quats: torch.Tensor,
                   scales: torch.Tensor, opacities: torch.Tensor,
                   colors: torch.Tensor, cam: Camera, group: TileGroup,
                   active: torch.Tensor | None = None, *, tile: int = 16,
                   span_cap: int = 3, max_pairs_per_tile: int = 1024,
                   chunk: int = 128) -> torch.Tensor:
    """`tiled.render_tiled` with the blend sharded over the group's ranks:
    the full (C, H, W) image on every rank, differentiable in every float
    input, the image and the gradients those of `render_tiled`."""
    need_grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in (means_cam, quats, scales, opacities, colors))
    rec_src, binned, _ = _binned_sources(
        means_cam, quats, scales, opacities, colors, cam, active, tile,
        span_cap, max_pairs_per_tile, chunk, need_grad)
    tiles_x = -(-cam.width // tile)
    n_tiles = binned.tab.shape[0]
    tab, counts = pad_bin_tables(binned.tab, binned.counts, group.world)
    if need_grad:
        inv = slot_inverse(binned.inv_pos)
        accum = BlendGatherSharded.apply(rec_src, tab, counts, inv.pos, inv.w,
                                         tiles_x, group)
    else:
        lo, Tl = shard_rows(tab.shape[0], group)
        accum = all_gather_rows(blend_forward(
            gather_channels(rec_src, tab[lo:lo + Tl]), counts[lo:lo + Tl],
            tiles_x, BLEND_CHANNELS, tile_offset=lo), group)
    return blend_image(accum[:n_tiles], cam, colors.shape[1])


def _render6(params: GaussianParams, active, quat, trans, cam, group,
             raster_kwargs):
    """`losses.render_slam`'s (r, g, b, z, 1, z^2) image, sharded."""
    return sharded_render(*_slam_inputs(params, quat, trans), cam, group,
                          active, **dict(raster_kwargs))


def sharded_tracking_step(params: GaussianParams, active: torch.Tensor,
                          cam_quat: torch.Tensor, cam_trans: torch.Tensor,
                          gt_color: torch.Tensor, gt_depth: torch.Tensor,
                          cam: Camera, group: TileGroup,
                          raster_kwargs: tuple = (), lr_quat: float = 4e-4,
                          lr_trans: float = 2e-3):
    """One sharded tracking SGD step on the silhouette-masked sum losses:
    (loss, new quat, new trans), the same on every rank."""
    q = cam_quat.detach().requires_grad_(True)
    t = cam_trans.detach().requires_grad_(True)
    img = _render6(params, active, q, t, cam, group, raster_kwargs)
    im, depth, sil = img[:3], img[3:4], img[4]
    m = (gt_depth > 0) & (sil > 0.5)[None]
    loss = (0.5 * (torch.abs(gt_color - im) * m).sum()
            + 0.025 * (torch.abs(gt_depth - depth) * m).sum())
    gq, gt = torch.autograd.grad(loss, (q, t))
    return (loss.detach(), (q - lr_quat * gq).detach(),
            (t - lr_trans * gt).detach())


def sharded_mapping_step(params: GaussianParams, active: torch.Tensor,
                         cam_quat: torch.Tensor, cam_trans: torch.Tensor,
                         gt_color: torch.Tensor, gt_depth: torch.Tensor,
                         cam: Camera, group: TileGroup,
                         raster_kwargs: tuple = (), lr: float = 1e-3):
    """One sharded mapping SGD step on rgb, logit opacity and log scale:
    (loss, new params), the same on every rank."""
    leaves = [x.detach().requires_grad_(True) for x in
              (params.rgb_colors, params.logit_opacities, params.log_scales)]
    p = params.replace(rgb_colors=leaves[0], logit_opacities=leaves[1],
                       log_scales=leaves[2])
    img = _render6(p, active, cam_quat, cam_trans, cam, group, raster_kwargs)
    im, depth = img[:3], img[3:4]
    m = gt_depth > 0
    n = torch.clamp(m.sum(), min=1)
    loss = ((torch.abs(gt_color - im) * m).sum()
            + (torch.abs(gt_depth - depth) * m).sum()) / n
    grads = torch.autograd.grad(loss, leaves)
    new = params.replace(**{k: (x - lr * g).detach() for k, x, g in zip(
        ("rgb_colors", "logit_opacities", "log_scales"), leaves, grads)})
    return loss.detach(), new
