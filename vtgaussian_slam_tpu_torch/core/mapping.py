"""Mapping: one frame's Gaussian optimization.

Parity: `vtgaussian_slam_tpu/core/mapping.py` (`map_frame`,
`map_binned_loop`, `map_frame_binned`). Every iteration draws a keyframe
uniformly, renders, takes the mapping loss and steps Adam (eps 1e-15).
The binned route renders the (N, 8) field table through the keyframe's
frozen binning (map_cache.splat_binned: SG + K1, backward K3 + SI) with
zero lr on the mean columns; the generic route (`map_frame`) renders from
scratch (render_slam: K4, backward K5) and steps every leaf whose lr is
nonzero, per leaf.

The global-consistency term (`use_global`): when the drawn keyframe's
frame id is a multiple of baseframe_every, the loss of a render of
[two frozen sections; the trainable section] at that keyframe is added.
It carries gradient on the phase's first iteration only and is a logged
value afterwards (skipped when `log_global_loss` is off; the trained
parameters are the same either way), as the JAX loops do. The frozen rows
never take a gradient.

Draws: production draws come from a `torch.Generator` on the host (no
device read per iteration); tests inject the JAX engine's draws instead,
because `jax.random` and torch generators give different streams.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..models.gaussians import PARAM_KEYS, GaussianParams
from ..models.optimizer import MAP_EPS, adam_init, adam_step
from ..ops.camera import Camera
from ..ops.map_loss import map_loss_forward
from ..ops.rasterizer.cuda_slots import slot_gather
from .losses import Frame, LossConfig, compute_loss, loss_from_render


class MappingConfig(NamedTuple):
    num_iters: int
    lrs: tuple             # sorted (field_name, lr) pairs
    loss_cfg: LossConfig   # tracking=False
    use_global: bool
    baseframe_every: int = 1
    log_global_loss: bool = True
    keep_hist: bool = True    # fill the per-iteration loss history


class KeyframeBuffer(NamedTuple):
    """Candidate keyframes for one mapping phase. The binned route keeps
    the keyframe poses in its per-keyframe bin caches; the generic route
    reads them here."""
    colors: torch.Tensor   # (B, 3, H, W)
    depths: torch.Tensor   # (B, 1, H, W)
    count: int             # number of keyframes to draw from
    quats: torch.Tensor | None = None   # (B, 4) w2c rotations (generic)
    trans: torch.Tensor | None = None   # (B, 3)
    frame_ids: Sequence[int] | None = None   # (B,) dataset frame ids


def lrs8_of(lrs: dict, like: torch.Tensor) -> torch.Tensor:
    """(1, 8) per-column lrs of the field table (zero on the means), filled
    on `like`'s device: a copy from the host would wait for the stream."""
    out = like.new_zeros((1, 8))
    for cols, name in ((slice(3, 4), "logit_opacities"),
                       (slice(4, 5), "log_scales"),
                       (slice(5, 8), "rgb_colors")):
        out[:, cols].fill_(lrs.get(name, 0.0))
    return out


class KernelIters:
    """`iters`: the mapping iterations so far whose own loss or render (the
    global term's apart) launched `wrapper`'s kernel, read from the
    wrapper's launch count around that step. The engine's counters read
    them around each mapping loop: `map.loss_fused` FUSED (the mapping-loss
    kernel, `ops/map_loss.map_loss_forward`), `map.slot_kernels` SLOTS (the
    slot gather SG, `ops/rasterizer/cuda_slots.slot_gather`)."""

    def __init__(self, wrapper):
        self.wrapper = wrapper
        self.iters = 0

    def took(self, launches_before: int):
        self.iters += self.wrapper.launches - launches_before


FUSED = KernelIters(map_loss_forward)
SLOTS = KernelIters(slot_gather)


def _draw(i: int, count: int, draws, generator) -> int:
    if draws is not None:
        return int(draws[i])
    return int(torch.randint(0, count, (), generator=generator))


def _global_mode(cfg: MappingConfig, kf: KeyframeBuffer, ring: int, i: int):
    """How iteration i takes the global term for keyframe `ring`: "grad"
    (the first iteration), "value" (later ones, when logged) or None."""
    if not cfg.use_global or kf.frame_ids[ring] % cfg.baseframe_every:
        return None
    if i == 0:
        return "grad"
    return "value" if cfg.log_global_loss else None


def map_frame(params: GaussianParams, active: torch.Tensor,
              kf: KeyframeBuffer, cam: Camera, cfg: MappingConfig,
              draws: Sequence[int] | None = None,
              generator: torch.Generator | None = None,
              fixed_params: GaussianParams | None = None,
              fixed_active: torch.Tensor | None = None):
    """The generic mapping loop: per iteration, render the section from
    scratch at a drawn keyframe's pose (render_slam), take the mapping loss
    and step Adam per leaf on the leaves with nonzero lr; zero-lr leaves
    stay frozen and take no gradient. With `cfg.use_global`, the global
    term renders [fixed_params (detached); the section]. `draws` (keyframe
    indices, one per iteration) replace the generator's uniform draws over
    `kf.count`. Returns (params, (num_iters, 3) history [loss, im, depth]),
    the history None when `cfg.keep_hist` is off."""
    from .map_cache import concat_params
    lr_of = dict(cfg.lrs)
    names = [a for f, a in PARAM_KEYS if lr_of.get(f, 0.0) != 0.0]
    lrs = [lr_of[f] for f, a in PARAM_KEYS if a in names]
    leaves = [getattr(params, a).detach() for a in names]
    frozen = {a: getattr(params, a).detach() for _, a in PARAM_KEYS
              if a not in names}
    opt = adam_init(leaves)
    if cfg.use_global:
        fixed = GaussianParams(*[x.detach() for x in fixed_params.tensors()])
    hist = (torch.zeros((cfg.num_iters, 3), device=params.means3d.device)
            if cfg.keep_hist else None)
    for i in range(cfg.num_iters):
        k = _draw(i, kf.count, draws, generator)
        frame = Frame(color=kf.colors[k], depth=kf.depths[k])
        vs = [x.requires_grad_(True) for x in (v.detach() for v in leaves)]
        p = GaussianParams(**frozen, **dict(zip(names, vs)))
        n0 = map_loss_forward.launches
        out = compute_loss(p, active, kf.quats[k], kf.trans[k], frame, cam,
                           cfg.loss_cfg, 0.5, False)
        FUSED.took(n0)
        loss = out.loss
        mode = _global_mode(cfg, kf, k, i)
        if mode is not None:
            with torch.set_grad_enabled(mode == "grad"):
                g_loss = compute_loss(
                    concat_params(fixed, p),
                    torch.cat([fixed_active, active]), kf.quats[k],
                    kf.trans[k], frame, cam, cfg.loss_cfg, 0.5, False).loss
            loss = loss + g_loss
        grads = list(torch.autograd.grad(loss, vs)) if vs else []
        leaves, opt = adam_step(leaves, grads, opt, lrs, eps=MAP_EPS)
        if hist is not None:
            hist[i] = torch.stack([loss, out.im_loss, out.depth_loss]).detach()
    return GaussianParams(**frozen, **dict(zip(names, leaves))), hist


def map_binned_loop(render_local, params: GaussianParams, kf: KeyframeBuffer,
                    kfc: Sequence, slot_ids: Sequence[int], cfg: MappingConfig,
                    draws: Sequence[int] | None = None,
                    generator: torch.Generator | None = None,
                    render_global=None):
    """The mapping loop over binned renderers `render_local(f8, kfc_slot)`
    and, with `cfg.use_global`, `render_global(f8)`. `draws` (cache-slot
    indices, one per iteration) replace the generator's uniform draws over
    the `kf.count` cached slots. Returns (params, (num_iters, 3) history
    [loss, im, depth]), the history None when `cfg.keep_hist` is off."""
    from .map_cache import pack_fields8, unpack_fields8

    lrs8 = lrs8_of(dict(cfg.lrs), params.means3d)
    f8 = pack_fields8(params)
    opt = adam_init([f8])
    hist = (torch.zeros((cfg.num_iters, 3), device=f8.device)
            if cfg.keep_hist else None)
    half = torch.full((), 0.5, device=f8.device)
    for i in range(cfg.num_iters):
        slot = _draw(i, kf.count, draws, generator)
        ring = slot_ids[slot]
        frame = Frame(color=kf.colors[ring], depth=kf.depths[ring])
        v8 = f8.detach().requires_grad_(True)
        n0 = slot_gather.launches
        r = render_local(v8, kfc[slot])
        SLOTS.took(n0)
        n0 = map_loss_forward.launches
        out = loss_from_render(r, frame, cfg.loss_cfg, half, False)
        FUSED.took(n0)
        loss = out.loss
        mode = _global_mode(cfg, kf, ring, i)
        if mode is not None:
            with torch.set_grad_enabled(mode == "grad"):
                g_loss = loss_from_render(render_global(v8), frame,
                                          cfg.loss_cfg, half, False).loss
            loss = loss + g_loss
        (g8,) = torch.autograd.grad(loss, (v8,))
        (f8,), opt = adam_step([f8], [g8], opt, [lrs8], eps=MAP_EPS)
        if hist is not None:
            hist[i] = torch.stack([loss, out.im_loss, out.depth_loss]).detach()
    return unpack_fields8(params, f8), hist


def map_frame_binned(params: GaussianParams, kf: KeyframeBuffer, kfc: Sequence,
                     slot_ids: Sequence[int], cam: Camera, cfg: MappingConfig,
                     draws: Sequence[int] | None = None,
                     generator: torch.Generator | None = None, gc=None):
    """`map_binned_loop` over per-keyframe frozen binnings
    (map_cache.render_binned) and, with `cfg.use_global`, the global
    binning `gc` (map_cache.GlobalBinCache)."""
    from .map_cache import render_binned, render_binned_global

    def render_local(v8, k):
        return render_binned(v8, k, cam)

    def render_global(v8):
        return render_binned_global(v8, gc, cam)

    return map_binned_loop(render_local, params, kf, kfc, slot_ids, cfg,
                           draws=draws, generator=generator,
                           render_global=render_global)
