"""Frozen-binning mapping renderer with inverse-map gradients.

Parity: `vtgaussian_slam_tpu/core/map_cache.py`. Mapping trains only
rgb / logit opacity / log scale (the means and rotations have zero mapping
lr in every config) and keyframe poses are fixed, so each keyframe's tile
tables, depth order and inverse map are built once (`build_kf_cache`) and
reused. Per mapping iteration `splat_binned` is one autograd Function:
slot gather from the (N, 8) field table (SG) -> K1 forward; backward: K3
(row-major per-slot gradients) -> the slot-inverse sum (SI, the
scatter-free transpose of the gather; `ops/rasterizer/cuda_slots.py`).

`MapCacheStore` keeps the per-keyframe caches of the current section with
the JAX engine's refresh policy. `GlobalBinCache` is the binning of
[frozen sections; trainable section] at the section's base keyframe for
the global-consistency term, and `trunc_probe` measures what the pair
budget truncates: the share of pixels a render at the budget and one at
4x it disagree on.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.gaussians import GaussianParams
from ..ops import geometry as geo
from ..ops.camera import Camera
from ..ops.rasterizer.binning import (SlotInv, bin_gaussians,
                                      gather_channels, slot_inverse)
from ..ops.rasterizer.cuda_slots import slot_gather, slot_inverse_sum
from ..ops.rasterizer.cuda_splat import (assemble_image, splat_backward_vals_rows,
                                         splat_forward)
from .losses import RenderResult
from .track_cache import (accum_result, fields8, pad_bin_tables,
                          project_at)


class KFBinCache(NamedTuple):
    tab: torch.Tensor       # (T, mpt) int64
    counts: torch.Tensor    # (T,) int32
    inv: SlotInv            # sorted inverse map
    quat: torch.Tensor      # (4,) keyframe w2c rotation (unnormalized)
    trans: torch.Tensor     # (3,)


class GlobalBinCache(NamedTuple):
    """Binning of [frozen sections; trainable section] at the base
    keyframe's pose."""
    tab: torch.Tensor            # (T, mpt) int64 rows of the concat
    counts: torch.Tensor         # (T,) int32
    inv: SlotInv                 # sorted inverse of the TRAINABLE rows only
    quat: torch.Tensor           # (4,)
    trans: torch.Tensor          # (3,)
    fixed_fields8: torch.Tensor  # (n_fixed, 8) frozen field rows


def pack_fields8(params: GaussianParams) -> torch.Tensor:
    """The (N, 8) field table [means3d, logit_op, log_scale, rgb]."""
    return fields8(params)


def unpack_fields8(params: GaussianParams, f8: torch.Tensor) -> GaussianParams:
    return params.replace(logit_opacities=f8[:, 3:4].contiguous(),
                          log_scales=f8[:, 4:5].contiguous(),
                          rgb_colors=f8[:, 5:8].contiguous())


def _bin_at(params: GaussianParams, active: torch.Tensor,
            cam_quat: torch.Tensor, cam_trans: torch.Tensor, cam: Camera,
            tile: int, span_cap: int, max_pairs_per_tile: int, select: str,
            with_inverse: bool = True):
    """Project the isotropic Gaussians at a pose and bin them (with the
    inverse map), at the pair budget rounded up to 128."""
    tiles_x = -(-cam.width // tile)
    tiles_y = -(-cam.height // tile)
    mpt = -(-max_pairs_per_tile // 128) * 128
    proj = project_at(params, active, cam_quat, cam_trans, cam)
    return bin_gaussians(proj, tile, span_cap, tiles_x, tiles_y, mpt,
                         with_inverse=with_inverse, select=select)


@torch.no_grad()
def build_kf_cache(params: GaussianParams, active: torch.Tensor,
                   cam_quat: torch.Tensor, cam_trans: torch.Tensor,
                   cam: Camera, *, tile: int = 16, span_cap: int = 2,
                   max_pairs_per_tile: int = 512, tile_pad: int = 0,
                   select: str = "depth") -> KFBinCache:
    b = _bin_at(params, active, cam_quat, cam_trans, cam, tile, span_cap,
                max_pairs_per_tile, select)
    tab, counts = pad_bin_tables(b.tab, b.counts, tile_pad)
    return KFBinCache(tab=tab, counts=counts, inv=slot_inverse(b.inv_pos),
                      quat=cam_quat, trans=cam_trans)


def concat_params(fixed: GaussianParams, params: GaussianParams
                  ) -> GaussianParams:
    """[fixed; params], field by field."""
    return GaussianParams(*[torch.cat([f, p]) for f, p in
                            zip(fixed.tensors(), params.tensors())])


@torch.no_grad()
def build_global_cache(fixed_params: GaussianParams,
                       fixed_active: torch.Tensor, params: GaussianParams,
                       active: torch.Tensor, cam_quat: torch.Tensor,
                       cam_trans: torch.Tensor, cam: Camera, *,
                       tile: int = 16, span_cap: int = 2,
                       max_pairs_per_tile: int = 512, tile_pad: int = 0,
                       select: str = "depth") -> GlobalBinCache:
    """Bin [fixed; trainable] at the base keyframe's pose. The inverse map
    covers the trainable rows only (those after the fixed CAPACITY), so
    the global term's gradient reaches the trainable section alone."""
    b = _bin_at(concat_params(fixed_params, params),
                torch.cat([fixed_active, active]), cam_quat, cam_trans, cam,
                tile, span_cap, max_pairs_per_tile, select)
    n_fixed = fixed_params.means3d.shape[0]
    tab, counts = pad_bin_tables(b.tab, b.counts, tile_pad)
    return GlobalBinCache(tab=tab, counts=counts,
                          inv=slot_inverse(b.inv_pos[n_fixed:]),
                          quat=cam_quat, trans=cam_trans,
                          fixed_fields8=fields8(fixed_params))


class SplatBinned(torch.autograd.Function):
    """fields8 (M, 8) -> slot gather SG (frozen tab, 0 past each count) ->
    K1 -> accum (T, 8, 256). Backward: K3 rows -> slot-inverse sum SI ->
    d fields8 (means columns zero by construction); no pose gradient
    (mapping holds poses fixed)."""

    @staticmethod
    def forward(ctx, f8, tab, inv_pos, inv_w, quat, trans, counts, cam):
        tiles_x = -(-cam.width // 16)
        R9 = geo.quat_to_rotmat(geo.normalize(quat)).reshape(9)
        slots = slot_gather(f8, tab, counts)
        accum = splat_forward(slots, R9, trans, counts, cam, tiles_x)
        ctx.save_for_backward(slots, R9, trans, counts, accum, inv_pos, inv_w)
        ctx.cam, ctx.M = cam, f8.shape[0]
        return accum

    @staticmethod
    def backward(ctx, g):
        slots, R9, trans, counts, accum, inv_pos, inv_w = ctx.saved_tensors
        tiles_x = -(-ctx.cam.width // 16)
        rows = splat_backward_vals_rows(slots, R9, trans, counts, accum, g,
                                        ctx.cam, tiles_x)          # (T, mpt, 8)
        g_tail = slot_inverse_sum(rows.reshape(-1, 8), inv_pos, inv_w)
        Ng = inv_pos.shape[0]
        if Ng < ctx.M:
            g_tail = torch.cat([g_tail.new_zeros((ctx.M - Ng, 8)), g_tail])
        return g_tail, None, None, None, None, None, None, None


def splat_binned(f8: torch.Tensor, tab: torch.Tensor, inv: SlotInv,
                 quat: torch.Tensor, trans: torch.Tensor, counts: torch.Tensor,
                 cam: Camera) -> torch.Tensor:
    return SplatBinned.apply(f8, tab, inv.pos, inv.w, quat, trans, counts, cam)


def accum_to_result(accum: torch.Tensor, cam: Camera, tile: int = 16
                    ) -> RenderResult:
    return accum_result(accum, cam, accum.new_zeros((1,)), tile)


def render_binned(f8: torch.Tensor, kfc: KFBinCache, cam: Camera
                  ) -> RenderResult:
    """Render the trainable section through one keyframe's frozen binning."""
    return accum_to_result(splat_binned(f8, kfc.tab, kfc.inv, kfc.quat,
                                        kfc.trans, kfc.counts, cam), cam)


def render_binned_global(f8: torch.Tensor, gc: GlobalBinCache, cam: Camera
                         ) -> RenderResult:
    """Render [frozen prefix; trainable section] through the global
    binning; the gradient reaches `f8` (the trainable rows) only."""
    cat = torch.cat([gc.fixed_fields8.detach(), f8])
    return accum_to_result(splat_binned(cat, gc.tab, gc.inv, gc.quat,
                                        gc.trans, gc.counts, cam), cam)


@torch.no_grad()
def trunc_probe(params: GaussianParams, active: torch.Tensor,
                quat: torch.Tensor, trans: torch.Tensor, cam: Camera,
                span_cap: int = 2, mpt: int = 512,
                select: str = "importance") -> torch.Tensor:
    """The measured truncation harm at one pose: the share of pixels whose
    rgb differs by more than 1/255 between the render at the pair budget
    `mpt` and the render at 4 mpt (K1 once each). A device scalar: the engine reads it a frame
    later, so the probe adds no host wait. Each binning and its slots live
    only inside this call."""
    f8 = pack_fields8(params)
    R9 = geo.quat_to_rotmat(geo.normalize(quat)).reshape(9)
    tiles_x = -(-cam.width // 16)
    ims = []
    for budget in (mpt, 4 * mpt):
        b = _bin_at(params, active, quat, trans, cam, 16, span_cap, budget,
                    select, with_inverse=False)
        accum = splat_forward(gather_channels(f8, b.tab), R9, trans,
                              b.counts, cam, tiles_x)
        del b
        ims.append(assemble_image(accum, cam)[:3])
        del accum
    diff = (ims[0] - ims[1]).abs().amax(0)
    return (diff > 1.0 / 255.0).float().mean()


class MapCacheStore:
    """Per-keyframe bin caches of the CURRENT section.

    Policy (as the JAX engine's): the just-tracked frame's cache is built
    fresh every mapping phase; per phase the stalest other slot is
    rebuilt (built with fewer gaussians than now, or STALE_AGE phases
    ago); a shape change (capacity or pair budget) rebuilds every slot; when
    the section has more keyframes than the W slots asked for, ring 0
    stays and the oldest other slot is evicted. Slots are a Python list of
    caches rather than one stacked buffer; `tile_pad` pads the tables for a
    tile-sharded group. `n_built` is the number of caches the last
    `update` built."""

    STALE_AGE = 12

    def __init__(self, select: str = "depth", tile_pad: int = 0):
        self.select = select
        self.tile_pad = tile_pad
        self.reset()

    def reset(self):
        self.slots: list[KFBinCache] = []
        self.key = None
        self.ring_of_slot: list[int] = []
        self.built_n: list[int] = []
        self.built_tick: list[int] = []
        self.tick = 0
        self.n_built = 0
        self.poses: dict[int, tuple] = {}

    def _build(self, params, active, ring_idx, cam, span_cap, mpt):
        quat, trans = self.poses[ring_idx]
        self.n_built += 1
        return build_kf_cache(params, active, quat, trans, cam,
                              span_cap=span_cap, max_pairs_per_tile=mpt,
                              tile_pad=self.tile_pad, select=self.select)

    def update(self, params, active, n_active: int, ring_idx: int, quat,
               trans, cam, span_cap: int, mpt: int, W: int):
        """Ensure caches exist for every registered keyframe of the section
        and refresh stale slots. Returns (slots, slot -> ring ids, count)."""
        self.poses[ring_idx] = (quat, trans)
        self.tick += 1
        self.n_built = 0
        key = (params.means3d.shape[0], mpt, cam.height, cam.width, W)
        if self.key != key:
            self.slots, self.ring_of_slot = [], []
            self.built_n, self.built_tick = [], []
            self.key = key
        missing = [r for r in sorted(self.poses) if r not in self.ring_of_slot]
        for r in missing:
            self._admit(r, self._build(params, active, r, cam, span_cap, mpt),
                        n_active, W)
        stale = [i for i, b in enumerate(self.built_n)
                 if (b < n_active
                     or self.tick - self.built_tick[i] >= self.STALE_AGE)
                 and self.ring_of_slot[i] != ring_idx]
        if stale:
            slot = min(stale, key=lambda i: (self.built_n[i],
                                             self.built_tick[i]))
            self.slots[slot] = self._build(params, active,
                                           self.ring_of_slot[slot], cam,
                                           span_cap, mpt)
            self.built_n[slot] = n_active
            self.built_tick[slot] = self.tick
        return self.slots, list(self.ring_of_slot), len(self.ring_of_slot)

    def _admit(self, ring_idx, built, n_active, W):
        if len(self.ring_of_slot) < W:
            self.ring_of_slot.append(ring_idx)
            self.built_n.append(n_active)
            self.built_tick.append(self.tick)
            self.slots.append(built)
            return
        candidates = [i for i, r in enumerate(self.ring_of_slot)
                      if r != 0] or list(range(len(self.ring_of_slot)))
        slot = min(candidates, key=lambda i: self.ring_of_slot[i])
        self.poses.pop(self.ring_of_slot[slot], None)
        self.ring_of_slot[slot] = ring_idx
        self.built_n[slot] = n_active
        self.built_tick[slot] = self.tick
        self.slots[slot] = built
