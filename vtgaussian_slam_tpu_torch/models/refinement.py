"""Gaussian-splatting refinement: opacity pruning and split / clone
densification.

Parity: `vtgaussian_slam_tpu/models/refinement.py` (the reference's
`prune_gaussians`, `densify` and opacity reset, and the screen-gradient
statistics that drive them). No shipped config turns them on
(prune_gaussians=False, use_gaussian_splatting_densification=False) and
the engine does not call them; they complete the port's surface.

A Section is a capacity-padded buffer, so removal is a stable compaction
(kept rows first, in order) applied to the parameters, the per-Gaussian
statistics and the matching `AdamState` rows, with the freed tail zeroed;
insertion writes into the padded tail with zero moments. Plain PyTorch ops
on the section's device; the split's jitter comes from a caller's
`torch.Generator` or from explicit (n, cap, 3) normal samples.
"""
from __future__ import annotations

import math

import torch

from ..ops.geometry import quat_to_rotmat
from .gaussians import GaussianParams, GaussianVars, Section
from .optimizer import AdamState


def _compact(section: Section, opt: AdamState | None, keep: torch.Tensor):
    """Kept Gaussians to the buffer front (stable), the tail zeroed, the
    same permutation on the Adam rows; `n_active` becomes the kept count."""
    cap = section.capacity
    keep = keep & section.active_mask()
    perm = torch.argsort((~keep).to(torch.uint8), stable=True)
    n_new = int(keep.sum())
    live = torch.arange(cap, device=keep.device) < n_new

    def reorder(x):
        if x.dim() == 0 or x.shape[0] != cap:
            return x
        y = x[perm]
        return torch.where(live.reshape((-1,) + (1,) * (y.dim() - 1)), y,
                           torch.zeros_like(y))

    p, v = section.params, section.vars
    params = GaussianParams(*[reorder(x) for x in p.tensors()])
    vars_ = GaussianVars(reorder(v.max_2d_radius),
                         reorder(v.means2d_grad_accum), reorder(v.denom),
                         reorder(v.timestep), v.scene_radius)
    if opt is not None:
        opt = AdamState(mu=[reorder(x) for x in opt.mu],
                        nu=[reorder(x) for x in opt.nu], count=opt.count)
    return Section(params=params, vars=vars_, n_active=n_new), opt


def prune_gaussians(section: Section, opt: AdamState | None, it: int,
                    prune_dict: dict):
    """Remove low-opacity (and, late enough, oversized) Gaussians on the
    prune cadence, and reset the opacities on theirs. `opt` holds the
    moments of the five fields in `GaussianParams` order, or is None."""
    if it > prune_dict["stop_after"]:
        return section, opt
    if it >= prune_dict["start_after"] and it % prune_dict["prune_every"] == 0:
        thresh = (prune_dict["final_removal_opacity_threshold"]
                  if it == prune_dict["stop_after"]
                  else prune_dict["removal_opacity_threshold"])
        to_remove = torch.sigmoid(section.params.logit_opacities[:, 0]) < thresh
        if it >= prune_dict["remove_big_after"]:
            big = torch.exp(section.params.log_scales).amax(1) > \
                0.1 * section.vars.scene_radius
            to_remove = to_remove | big
        section, opt = _compact(section, opt, ~to_remove)
    if (it > 0 and prune_dict.get("reset_opacities")
            and it % prune_dict["reset_opacities_every"] == 0):
        lo = section.params.logit_opacities
        new_logit = torch.where(section.active_mask()[:, None],
                                torch.full_like(lo, math.log(0.01 / 0.99)),
                                lo)
        section = section.replace(
            params=section.params.replace(logit_opacities=new_logit))
        if opt is not None:
            # the reference zeroes the reset leaf's moments
            mu, nu = list(opt.mu), list(opt.nu)
            mu[3] = torch.zeros_like(mu[3])
            nu[3] = torch.zeros_like(nu[3])
            opt = AdamState(mu=mu, nu=nu, count=opt.count)
    return section, opt


def accumulate_mean2d_gradient(vars_: GaussianVars, mean2d_grad: torch.Tensor,
                               seen: torch.Tensor) -> GaussianVars:
    """Add the screen-space positional gradient norms of the seen
    Gaussians to the statistics."""
    norm = torch.linalg.norm(mean2d_grad[:, :2], dim=-1)
    return GaussianVars(
        vars_.max_2d_radius,
        vars_.means2d_grad_accum + torch.where(seen, norm,
                                               torch.zeros_like(norm)),
        vars_.denom + seen.to(vars_.denom.dtype), vars_.timestep,
        vars_.scene_radius)


def densify_split_clone(section: Section, opt: AdamState | None, it: int,
                        densify_dict: dict,
                        generator: torch.Generator | None = None,
                        noise: torch.Tensor | None = None):
    """Clone small high-gradient Gaussians, split large ones into
    `num_to_split_into` jittered samples with scales shrunk by 1/(0.8 n),
    then remove the split originals and the low-opacity ones. The jitter
    is `noise` ((n, cap, 3) standard normals) when given, else drawn from
    `generator`. The caller guarantees the capacity (worst case n_active x
    (1 + n) rows); rows past it are dropped and not counted active."""
    if it > densify_dict["stop_after"]:
        return section, opt
    if not (it >= densify_dict["start_after"]
            and it % densify_dict["densify_every"] == 0):
        return section, opt

    p, v = section.params, section.vars
    cap = section.capacity
    dev = p.means3d.device
    active = section.active_mask()
    grads = torch.where(v.denom > 0, v.means2d_grad_accum / v.denom,
                        torch.zeros_like(v.denom))
    max_scale = torch.exp(p.log_scales).amax(1)
    small = max_scale <= 0.01 * v.scene_radius
    big_grad = grads >= densify_dict["grad_thresh"]
    to_clone = active & big_grad & small
    to_split = active & big_grad & ~small
    n = densify_dict["num_to_split_into"]

    def append(prm, ts_buf, src_mask, new_means, new_log_scales, n_active):
        dest = n_active + torch.cumsum(src_mask.to(torch.int64), 0) - 1
        ok = src_mask & (dest < cap)
        idx = dest[ok]

        def scat(buf, val):
            buf = buf.clone()
            buf[idx] = val[ok]
            return buf

        n_new = min(n_active + int(src_mask.sum()), cap)
        return GaussianParams(
            means3d=scat(prm.means3d, new_means),
            rgb_colors=scat(prm.rgb_colors, p.rgb_colors),
            unnorm_rotations=scat(prm.unnorm_rotations, p.unnorm_rotations),
            logit_opacities=scat(prm.logit_opacities, p.logit_opacities),
            log_scales=scat(prm.log_scales, new_log_scales),
        ), scat(ts_buf, v.timestep), n_new

    params, timestep, n_active = append(p, v.timestep, to_clone, p.means3d,
                                        p.log_scales, section.n_active)
    split_log_scales = p.log_scales - math.log(0.8 * n)
    R = quat_to_rotmat(p.unnorm_rotations)
    scales3 = torch.exp(p.log_scales).expand(cap, 3)
    for k in range(n):
        eps = (noise[k].to(device=dev, dtype=p.means3d.dtype)
               if noise is not None else
               torch.randn((cap, 3), generator=generator).to(dev))
        offset = torch.einsum("nij,nj->ni", R, eps * scales3)
        params, timestep, n_active = append(
            params, timestep, to_split, p.means3d + offset,
            split_log_scales, n_active)

    zeros = torch.zeros((cap,), dtype=p.means3d.dtype, device=dev)
    vars_ = GaussianVars(zeros, zeros.clone(), zeros.clone(), timestep,
                         v.scene_radius)
    section = Section(params=params, vars=vars_, n_active=n_active)
    # appended rows keep zero Adam moments: the tail rows are zero from
    # adam_init and every compaction

    thresh_op = (densify_dict["final_removal_opacity_threshold"]
                 if it == densify_dict["stop_after"]
                 else densify_dict["removal_opacity_threshold"])
    to_remove = to_split | (torch.sigmoid(params.logit_opacities[:, 0])
                            < thresh_op)
    if it >= densify_dict["remove_big_after"]:
        big = torch.exp(params.log_scales).amax(1) > 0.1 * v.scene_radius
        to_remove = to_remove | big
    return _compact(section, opt, ~to_remove)
