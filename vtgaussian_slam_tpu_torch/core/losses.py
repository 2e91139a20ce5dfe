"""Fused render + masked photometric/depth losses.

Parity: `vtgaussian_slam_tpu/core/losses.py`. One 6-channel render gives
(r, g, b, z, 1, z^2), differentiable in the pose and every Gaussian field
(the generic route: K4 forward, K5 backward). The losses apply the
reference's mask stack: valid depth, optional outlier rejection at 50x the
lower-middle median depth error, the tracking silhouette (with the Replica adaptive threshold sweep
on a frame's first iteration), and an auxiliary visibility / far-depth
mask. Tracking losses are sums; mapping uses mean L1 depth and
0.8 L1 + 0.2 (1 - SSIM) colour. On a card the mapping loss without outlier
rejection or an auxiliary mask (every mapping caller's) is one kernel with
its gradient (`ops/map_loss.py`); everything else is PyTorch ops.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..models.gaussians import GaussianParams
from ..ops import geometry as geo
from ..ops.camera import Camera
from ..ops.map_loss import map_loss
from ..ops.rasterizer.tiled import render_tiled, tile_records
from ..ops.ssim import ssim

SIL_THRES_CANDIDATES = (0.990, 0.993, 0.995, 0.997, 0.999)


@dataclass
class Frame:
    """Device-staged RGB-D frame: color (3, H, W) in [0, 1], depth (1, H, W)."""
    color: torch.Tensor
    depth: torch.Tensor


class LossConfig(NamedTuple):
    tracking: bool
    use_sil_for_loss: bool
    ignore_outlier_depth_loss: bool
    adaptive_sil: bool
    im_weight: float
    depth_weight: float
    backend_kwargs: tuple = ()  # render_tiled kwargs, as sorted items


class RenderResult(NamedTuple):
    im: torch.Tensor          # (3, H, W)
    depth: torch.Tensor       # (1, H, W)
    silhouette: torch.Tensor  # (H, W)
    depth_sq: torch.Tensor    # (1, H, W)
    radii: torch.Tensor       # (N,)


class LossOutput(NamedTuple):
    loss: torch.Tensor
    im_loss: torch.Tensor
    depth_loss: torch.Tensor
    sil_thres_out: torch.Tensor


def _slam_inputs(params: GaussianParams, cam_quat: torch.Tensor,
                 cam_trans: torch.Tensor):
    """Camera-frame means, rotations (rotated into the camera frame when
    anisotropic), scales, opacities and the (r, g, b, z, 1, z^2) colours."""
    q = geo.normalize(cam_quat)
    R = geo.quat_to_rotmat(q)
    means_cam = params.means3d @ R.T + cam_trans
    if params.isotropic:
        quats = params.unnorm_rotations
    else:
        quats = geo.quat_mult(q[None, :], geo.normalize(params.unnorm_rotations))
    z = means_cam[:, 2]
    colors6 = torch.cat(
        [params.rgb_colors, torch.stack([z, torch.ones_like(z), z * z], -1)], 1)
    return (means_cam, quats, torch.exp(params.log_scales), params.opacities(),
            colors6)


def slam_records(params: GaussianParams, active: torch.Tensor,
                 cam_quat: torch.Tensor, cam_trans: torch.Tensor, cam: Camera,
                 backend_kwargs: dict | None = None):
    """`render_slam`'s blend inputs: the (r, g, b, z, 1, z^2) records per
    tile at a camera pose, their counts and the radii (`tile_records`)."""
    return tile_records(*_slam_inputs(params, cam_quat, cam_trans), cam,
                        active, **(backend_kwargs or {}))


def render_slam(params: GaussianParams, active: torch.Tensor,
                cam_quat: torch.Tensor, cam_trans: torch.Tensor, cam: Camera,
                backend_kwargs: dict | None = None) -> RenderResult:
    """Fused RGB + depth/silhouette render at a camera pose. Gradients
    reach whichever of (params, cam_quat, cam_trans) require them;
    densify and eval call it under `torch.no_grad`."""
    img6, radii = render_tiled(*_slam_inputs(params, cam_quat, cam_trans),
                               cam, active, **(backend_kwargs or {}))
    return RenderResult(im=img6[:3], depth=img6[3:4], silhouette=img6[4],
                        depth_sq=img6[5:6], radii=radii)


def lower_median(x: torch.Tensor) -> torch.Tensor:
    """torch.median / jnp.quantile(method='lower') semantics: the lower
    middle element for even sizes."""
    flat = x.reshape(-1)
    return torch.kthvalue(flat, (flat.numel() - 1) // 2 + 1).values


def _pick_sil_thres(r: RenderResult, frame: Frame) -> torch.Tensor:
    """Replica adaptive threshold: the candidate with the least masked
    colour MSE (a threshold covering no pixel never wins)."""
    cands = torch.tensor(SIL_THRES_CANDIDATES, dtype=frame.color.dtype,
                         device=frame.color.device)
    sq = ((frame.color - r.im) ** 2).detach()
    m = (r.silhouette.detach()[None] > cands[:, None, None]) \
        & (frame.depth[0] > 0)[None]                          # (K, H, W)
    msum = m.sum((1, 2)) * 3
    tot = torch.where(m[:, None], sq[None], torch.zeros_like(sq)[None]).sum(
        (1, 2, 3))
    mse = tot / torch.clamp(msum, min=1)
    mse = torch.where(msum > 0, mse, torch.full_like(mse, float("inf")))
    return cands[torch.argmin(mse)]


def compute_loss(params: GaussianParams, active: torch.Tensor,
                 cam_quat: torch.Tensor, cam_trans: torch.Tensor, frame: Frame,
                 cam: Camera, cfg: LossConfig, sil_thres, is_first_iter: bool,
                 aux_mask: torch.Tensor | None = None) -> LossOutput:
    """Weighted masked losses for one frame at one pose (generic renderer)."""
    r = render_slam(params, active, cam_quat, cam_trans, cam,
                    dict(cfg.backend_kwargs))
    return loss_from_render(r, frame, cfg, sil_thres, is_first_iter, aux_mask)


def fused_mapping_loss(cfg: LossConfig, device,
                       aux_mask: torch.Tensor | None = None) -> bool:
    """Whether `loss_from_render` takes the loss in the mapping-loss kernel
    (`ops/map_loss.py`): the mapping branch, without outlier rejection or
    an auxiliary mask, on a card."""
    return (not cfg.tracking and not cfg.ignore_outlier_depth_loss
            and aux_mask is None and torch.device(device).type == "cuda")


def loss_from_render(r: RenderResult, frame: Frame, cfg: LossConfig,
                     sil_thres, is_first_iter: bool,
                     aux_mask: torch.Tensor | None = None) -> LossOutput:
    """Weighted masked losses given a render; gradients flow to r.im and
    r.depth."""
    gt_im, gt_depth = frame.color, frame.depth
    sil_thres_out = torch.as_tensor(sil_thres, dtype=gt_im.dtype,
                                    device=gt_im.device)
    if fused_mapping_loss(cfg, gt_im.device, aux_mask):
        loss, im_loss, depth_loss = map_loss(
            r.im, r.depth, r.depth_sq, gt_im, gt_depth, cfg.im_weight,
            cfg.depth_weight)
        return LossOutput(loss=loss, im_loss=im_loss, depth_loss=depth_loss,
                          sil_thres_out=sil_thres_out)
    uncertainty = (r.depth_sq - r.depth * r.depth).detach()
    nan_mask = (~torch.isnan(r.depth)) & (~torch.isnan(uncertainty))
    valid = gt_depth > 0
    zero = torch.zeros((), dtype=gt_im.dtype, device=gt_im.device)

    if cfg.ignore_outlier_depth_loss:
        depth_error = torch.where(valid & nan_mask,
                                  (gt_depth - r.depth).abs(), zero).detach()
        mask = (depth_error < 50 * lower_median(depth_error)) & valid
    else:
        mask = valid
    mask = mask & nan_mask

    if cfg.tracking and cfg.use_sil_for_loss:
        if cfg.adaptive_sil and is_first_iter:
            sil_thres_out = _pick_sil_thres(r, frame)
        presence = r.silhouette.detach() > sil_thres_out
        mask = mask & presence[None]
    if aux_mask is not None:
        mask = mask & aux_mask[None]
    mask = mask.detach()

    ddiff = torch.where(mask, gt_depth - r.depth, zero)
    if cfg.tracking:
        depth_loss = ddiff.abs().sum()
        if cfg.use_sil_for_loss or cfg.ignore_outlier_depth_loss:
            im_loss = torch.where(mask, gt_im - r.im, zero).abs().sum()
        else:
            im_loss = (gt_im - r.im).abs().sum()
    else:
        depth_loss = ddiff.abs().sum() / torch.clamp(mask.sum(), min=1)
        im_loss = 0.8 * (r.im - gt_im).abs().mean() + 0.2 * (
            1.0 - ssim(r.im, gt_im))
    loss = cfg.im_weight * im_loss + cfg.depth_weight * depth_loss
    return LossOutput(loss=loss, im_loss=im_loss, depth_loss=depth_loss,
                      sil_thres_out=sil_thres_out)
