"""Tile-sharded twins of the cached tracking loop and the binned mapping
loop over `torch.distributed`.

Parity: `vtgaussian_slam_tpu/parallel/engine.py`. Every rank holds the
whole engine state, replicated, and renders one contiguous range of the
image's tile rows, at tile_offset = rank * tiles_local (the kernels'
`tile_offset` operand gives its pixels their global coordinates). Per
iteration of either loop:

  - each rank runs K1 on its rows and the (Tl, 8, 256) accums are
    all-gathered, so the loss (masks, medians, the adaptive silhouette
    threshold, SSIM windows) runs on the full image with the single-card
    code, the same on every rank;
  - the backward runs K2 (tracking) or K3 (mapping) on the rank's rows of
    the image cotangent and all-gathers their outputs: the (Tl, 12)
    per-tile pose partials, or the (Tl, mpt, 8) per-slot rows; every rank
    then reduces them exactly as the single-card renderer does (the pose
    partials summed over the real tiles, the rows through the whole
    inverse-map gather).

Difference by design: the JAX package all-reduces each device's partial
sums instead (12 pose floats; the (Ng, 8) field table from each device's
share of the inverse map). Those sums add the same terms in another
order, and the mapping loop turns such rounding into millimetres of
trajectory within a frame at the room0 proxy's size (PERF.md §6); the
gathered outputs keep the single-card order, so a sharded run is the
single-card run to the bit, for a similar message size (a rank's K3 rows,
Tl x mpt x 8 floats, against the field table, Ng x 8).

Caches pad to a multiple of `tile_pad_for(world)` = 8 x world rows (the JAX
package's rule), so a rank's range is the JAX mesh device's. Gathered
values are the same bits on every rank, so the ranks take the same steps
and the same host decisions (densify, the boundary policy, the pair
budget) from identically seeded generators.

Process groups: `init_process_group` joins the default group with its
rank, world size, device, backend and address given explicitly: NCCL with
a card per rank, gloo on the CPU, or gloo with every rank on one card
(NCCL refuses two ranks on one device). `make_mesh` is the JAX
`make_mesh`'s counterpart: the initialized group as a `TileGroup`.
"""
from __future__ import annotations

from datetime import timedelta
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..core.map_cache import accum_to_result
from ..core.mapping import map_binned_loop
from ..core.track_cache import TrackCache, accum_result
from ..core.tracking import track_loop
from ..ops import geometry as geo
from ..ops.rasterizer.binning import BLOCK, SlotInv
from ..ops.rasterizer.cuda_slots import slot_gather, slot_inverse_sum
from ..ops.rasterizer.cuda_splat import (splat_backward_pose,
                                         splat_backward_vals_rows,
                                         splat_forward)
from ..utils.common import resolve_device


class TileGroup(NamedTuple):
    """This process's place in the default process group: a 1-D mesh of
    `world` ranks over the image's tile rows."""
    rank: int
    world: int


def init_process_group(rank: int, world: int, device, backend: str,
                       init_method: str, timeout_s: float = 600.0
                       ) -> torch.device:
    """Join the default process group as `rank` of `world` on `device`
    ("cpu", "cuda:i") over `backend` ("nccl", "gloo") at `init_method`
    (e.g. tcp://localhost:PORT, or env:// under torchrun). A collective
    that waits longer than `timeout_s` raises. Returns the device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    return dev


def make_mesh(n_devices: int | None = None) -> TileGroup:
    """The default process group as a TileGroup; raises when it is not
    initialized or its world size is not `n_devices`."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and world != n_devices:
        raise ValueError(
            f"tpu.mesh_devices={n_devices} but the process group has {world} "
            f"rank(s){'' if dist.is_initialized() else ' (not initialized)'}: "
            f"launch one process per rank, e.g. torchrun --nproc_per_node="
            f"{n_devices} -m vtgaussian_slam_tpu_torch <config.py> --set "
            f"tpu.mesh_devices={n_devices}")
    return TileGroup(rank=dist.get_rank() if dist.is_initialized() else 0,
                     world=world)


def tile_pad_for(world: int) -> int:
    """The row multiple the cache builders pad to on a `world`-rank group,
    so every rank holds the same number of whole 8-row blocks."""
    return BLOCK * world


def shard_rows(T: int, group: TileGroup) -> tuple[int, int]:
    """(first row, rows) of this rank's contiguous share of T rows."""
    if T % group.world:
        raise ValueError(f"{T} tile rows do not split over {group.world} "
                         f"ranks: pad the tables to tile_pad_for(world)")
    Tl = T // group.world
    return group.rank * Tl, Tl


def all_gather_rows(x: torch.Tensor, group: TileGroup) -> torch.Tensor:
    """The ranks' (Tl, ...) shares concatenated in rank order, on every
    rank (a one-rank group needs no process group)."""
    if group.world == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(group.world)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# tracking: the frozen cache's rows sharded over ranks; K2's per-tile pose
# partials gathered and summed in the single-card order
# ---------------------------------------------------------------------------
class SplatPoseSharded(torch.autograd.Function):
    """(R9, trans) -> K1 on this rank's rows of the cache at its tile
    offset -> the gathered (Tp, 8, 256) accum. Backward: K2 on the rank's
    rows, the (Tp, 12) partials gathered and summed over the image's
    n_tiles real rows, as `SplatBlend`'s "pose" backward sums them."""

    @staticmethod
    def forward(ctx, R9, trans, cache, cam, group, n_tiles):
        tiles_x = -(-cam.width // 16)
        lo, Tl = shard_rows(cache.slots8.shape[0], group)
        slots, counts = cache.slots8[lo:lo + Tl], cache.counts[lo:lo + Tl]
        acc = splat_forward(slots, R9.detach(), trans.detach(), counts, cam,
                            tiles_x, tile_offset=lo)
        ctx.save_for_backward(R9.detach(), trans.detach(), acc)
        ctx.args = (slots, counts, cam, tiles_x, lo, Tl, group, n_tiles)
        return all_gather_rows(acc, group)

    @staticmethod
    def backward(ctx, g):
        R9, trans, acc = ctx.saved_tensors
        slots, counts, cam, tiles_x, lo, Tl, group, n_tiles = ctx.args
        part = splat_backward_pose(slots, R9, trans, counts, acc,
                                   g[lo:lo + Tl], cam, tiles_x,
                                   tile_offset=lo)
        tot = all_gather_rows(part, group)[:n_tiles].sum(0)
        return tot[:9], tot[9:12], None, None, None, None


def render_cached_sharded(cache: TrackCache, cam_quat: torch.Tensor,
                          cam_trans: torch.Tensor, cam, group: TileGroup):
    """`track_cache.render_cached` sharded over the group's ranks: the same
    render and pose gradient, to the bit."""
    n_tiles = (-(-cam.width // 16)) * (-(-cam.height // 16))
    R9 = geo.quat_to_rotmat(geo.normalize(cam_quat)).reshape(9)
    accum = SplatPoseSharded.apply(R9, cam_trans, cache, cam, group, n_tiles)
    return accum_result(accum, cam, cache.radii)


def make_track_frame_cached_sharded(group: TileGroup):
    """The tile-sharded twin of `tracking.track_frame_cached` (same
    signature): the full tracking loop (mask stack, Adam, the candidate
    metric) over `render_cached_sharded`. Caches are built with
    tile_pad=tile_pad_for(group.world)."""

    def track_frame_cached_sharded(cache, state, frame, aux_mask, cam, cfg,
                                   p2p_target=None):
        def render_fn(quat, trans):
            return render_cached_sharded(cache, quat, trans, cam, group)

        return track_loop(render_fn, state, frame, aux_mask, cfg, p2p_target,
                          cam)

    return track_frame_cached_sharded


# ---------------------------------------------------------------------------
# mapping: each keyframe's bin table sharded over ranks; K3's rows gathered
# and mapped onto the field table through the whole inverse map
# ---------------------------------------------------------------------------
class SplatBinnedSharded(torch.autograd.Function):
    """`map_cache.SplatBinned` on this rank's rows of `tab` (slot gather, K1
    at the rank's tile offset), the accums gathered. Backward: K3 on the
    rank's rows, the (Tp, mpt, 8) rows gathered and mapped through the
    inverse map as `SplatBinned` maps them."""

    @staticmethod
    def forward(ctx, f8, tab, counts, inv_pos, inv_w, quat, trans, cam,
                group):
        tiles_x = -(-cam.width // 16)
        lo, Tl = shard_rows(tab.shape[0], group)
        R9 = geo.quat_to_rotmat(geo.normalize(quat)).reshape(9)
        slots = slot_gather(f8, tab[lo:lo + Tl], counts[lo:lo + Tl])
        acc = splat_forward(slots, R9, trans, counts[lo:lo + Tl], cam,
                            tiles_x, tile_offset=lo)
        ctx.save_for_backward(slots, R9, trans, acc, inv_pos, inv_w)
        ctx.args = (counts[lo:lo + Tl], cam, tiles_x, lo, Tl, group,
                    f8.shape[0])
        return all_gather_rows(acc, group)

    @staticmethod
    def backward(ctx, g):
        slots, R9, trans, acc, inv_pos, inv_w = ctx.saved_tensors
        counts, cam, tiles_x, lo, Tl, group, M = ctx.args
        rows = splat_backward_vals_rows(slots, R9, trans, counts, acc,
                                        g[lo:lo + Tl], cam, tiles_x,
                                        tile_offset=lo)
        flat = all_gather_rows(rows, group).reshape(-1, 8)
        g_tail = slot_inverse_sum(flat, inv_pos, inv_w)
        Ng = inv_pos.shape[0]
        if Ng < M:
            g_tail = torch.cat([g_tail.new_zeros((M - Ng, 8)), g_tail])
        return g_tail, None, None, None, None, None, None, None, None


def splat_binned_sharded(f8: torch.Tensor, tab: torch.Tensor, inv: SlotInv,
                         quat: torch.Tensor, trans: torch.Tensor,
                         counts: torch.Tensor, cam, group: TileGroup):
    """`map_cache.splat_binned` sharded over the group's ranks: the same
    render and field gradient, to the bit."""
    return SplatBinnedSharded.apply(f8, tab, counts, inv.pos, inv.w, quat,
                                    trans, cam, group)


def make_map_frame_binned_sharded(group: TileGroup):
    """The tile-sharded twin of `mapping.map_frame_binned` (same signature,
    single-class caches): the full mapping loop (loss with SSIM, the global
    term, Adam) over sharded keyframe and global renders. Caches are built
    with tile_pad=tile_pad_for(group.world)."""

    def map_frame_binned_sharded(params, kf, kfc, slot_ids, cam, cfg,
                                 draws=None, generator=None, gc=None):
        def render_local(v8, k):
            return accum_to_result(splat_binned_sharded(
                v8, k.tab, k.inv, k.quat, k.trans, k.counts, cam, group), cam)

        def render_global(v8):
            cat = torch.cat([gc.fixed_fields8.detach(), v8])
            return accum_to_result(splat_binned_sharded(
                cat, gc.tab, gc.inv, gc.quat, gc.trans, gc.counts, cam,
                group), cam)

        return map_binned_loop(render_local, params, kf, kfc, slot_ids, cfg,
                               draws=draws, generator=generator,
                               render_global=render_global)

    return map_frame_binned_sharded
