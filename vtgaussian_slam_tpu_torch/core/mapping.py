"""Mapping: one frame's Gaussian optimization over frozen binnings.

Parity: `vtgaussian_slam_tpu/core/mapping.py` (`map_binned_loop`,
`map_frame_binned`, without the global-consistency term, which needs a
second section). Every iteration draws a cached keyframe uniformly,
renders the (N, 8) field table through that keyframe's frozen binning
(map_cache.splat_binned: K1 + K3), takes the mapping loss and steps Adam
(eps 1e-15) on the field table with zero lr on the mean columns.

Draws: production draws come from a `torch.Generator` on the host (no
device read per iteration); tests inject the JAX engine's draws instead,
because `jax.random` and torch generators give different streams.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..models.gaussians import GaussianParams
from ..models.optimizer import MAP_EPS, adam_init, adam_step
from ..ops.camera import Camera
from .losses import Frame, LossConfig, loss_from_render


class MappingConfig(NamedTuple):
    num_iters: int
    lrs: tuple             # sorted (field_name, lr) pairs
    loss_cfg: LossConfig   # tracking=False
    use_global: bool


class KeyframeBuffer(NamedTuple):
    """Candidate keyframes for one mapping phase (the section's ring; the
    keyframe poses live in the per-keyframe bin caches)."""
    colors: torch.Tensor   # (B, 3, H, W)
    depths: torch.Tensor   # (B, 1, H, W)
    count: int             # number of cached keyframes to draw from


def lrs8_of(lrs: dict, like: torch.Tensor) -> torch.Tensor:
    """(1, 8) per-column lrs of the field table (zero on the means)."""
    return torch.tensor(
        [0.0, 0.0, 0.0, lrs.get("logit_opacities", 0.0),
         lrs.get("log_scales", 0.0)] + [lrs.get("rgb_colors", 0.0)] * 3,
        dtype=like.dtype, device=like.device)[None, :]


def map_binned_loop(render_local, params: GaussianParams, kf: KeyframeBuffer,
                    kfc: Sequence, slot_ids: Sequence[int], cfg: MappingConfig,
                    draws: Sequence[int] | None = None,
                    generator: torch.Generator | None = None):
    """The mapping loop over a binned renderer `render_local(f8, kfc_slot)`.
    `draws` (cache-slot indices, one per iteration) replace the generator's
    uniform draws over the `kf.count` cached slots. Returns
    (params, (num_iters, 3) history [loss, im, depth])."""
    from .map_cache import pack_fields8, unpack_fields8

    if cfg.use_global:
        raise NotImplementedError(
            "the global-consistency term arrives with section boundaries")
    lrs8 = lrs8_of(dict(cfg.lrs), params.means3d)
    f8 = pack_fields8(params)
    opt = adam_init([f8])
    hist = torch.zeros((cfg.num_iters, 3), device=f8.device)
    half = torch.tensor(0.5, device=f8.device)
    for i in range(cfg.num_iters):
        if draws is not None:
            slot = int(draws[i])
        else:
            slot = int(torch.randint(0, kf.count, (), generator=generator))
        ring = slot_ids[slot]
        frame = Frame(color=kf.colors[ring], depth=kf.depths[ring])
        v8 = f8.detach().requires_grad_(True)
        r = render_local(v8, kfc[slot])
        out = loss_from_render(r, frame, cfg.loss_cfg, half, False)
        (g8,) = torch.autograd.grad(out.loss, (v8,))
        (f8,), opt = adam_step([f8], [g8], opt, [lrs8], eps=MAP_EPS)
        hist[i] = torch.stack([out.loss, out.im_loss, out.depth_loss]).detach()
    return unpack_fields8(params, f8), hist


def map_frame_binned(params: GaussianParams, kf: KeyframeBuffer, kfc: Sequence,
                     slot_ids: Sequence[int], cam: Camera, cfg: MappingConfig,
                     draws: Sequence[int] | None = None,
                     generator: torch.Generator | None = None):
    """`map_binned_loop` over per-keyframe frozen binnings
    (map_cache.render_binned)."""
    from .map_cache import render_binned

    def render_local(v8, k):
        return render_binned(v8, k, cam)

    return map_binned_loop(render_local, params, kf, kfc, slot_ids, cfg,
                           draws=draws, generator=generator)
