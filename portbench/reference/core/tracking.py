"""Camera tracking: one frame's pose optimization.

Parity: `vtgaussian_slam_tpu/core/tracking.py` (`track_loop`,
`track_frame` over the generic renderer, `track_frame_cached`). A fresh
Adam per frame on (quat, trans); each iteration renders, takes the masked
loss and its pose gradient, steps, and keeps the post-step pose with the
lowest metric as the best candidate: the PRE-step loss ("loss"), or at
section boundaries the post-step pose's point-to-plane distance to the
overlap frame ("p2p", core/p2p.py). The adaptive silhouette threshold is picked on the
frame's first iteration (count == 0) and carried. Best-candidate
bookkeeping stays on the device: the loop never waits on a host read.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..models.gaussians import GaussianParams
from ..ops import geometry as geo
from ..ops.camera import Camera
from .losses import (Frame, LossConfig, compute_loss, loss_from_render,
                     render_slam)
from .p2p import P2PTarget, point2plane_metric


class TrackingConfig(NamedTuple):
    num_iters: int
    lr_quat: float
    lr_trans: float
    metric: str            # "loss" | "p2p"
    loss_cfg: LossConfig
    p2p_method: str = "sum"   # "sum" | "max" | "max100"
    keep_hist: bool = True    # fill the per-iteration loss streams


@dataclass
class TrackState:
    quat: torch.Tensor
    trans: torch.Tensor
    m: torch.Tensor            # Adam first moment (7,) = [quat, trans]
    v: torch.Tensor
    count: int
    best_quat: torch.Tensor
    best_trans: torch.Tensor
    min_metric: torch.Tensor
    min_loss: torch.Tensor
    sil_thres: torch.Tensor
    im_loss: torch.Tensor
    depth_loss: torch.Tensor


def init_track_state(quat: torch.Tensor, trans: torch.Tensor,
                     sil_thres: float) -> TrackState:
    z7 = quat.new_zeros((7,))
    big = quat.new_tensor(1e20)
    return TrackState(quat=quat.detach().clone(), trans=trans.detach().clone(),
                      m=z7, v=z7.clone(), count=0, best_quat=quat.detach(),
                      best_trans=trans.detach(), min_metric=big, min_loss=big,
                      sil_thres=quat.new_tensor(sil_thres),
                      im_loss=quat.new_zeros(()), depth_loss=quat.new_zeros(()))


def track_loop(render_fn, state: TrackState, frame: Frame,
               aux_mask: torch.Tensor | None, cfg: TrackingConfig,
               p2p_target: P2PTarget | None = None, cam: Camera | None = None):
    """The tracking optimization loop over a pose-differentiable renderer
    `render_fn(quat, trans) -> RenderResult`. Metric "p2p" needs the
    overlap frame's `p2p_target` and the camera. Returns (state, im_hist,
    depth_hist) with the per-iteration loss streams (None, None when
    `cfg.keep_hist` is off)."""
    if cfg.metric not in ("loss", "p2p"):
        raise ValueError(f"unknown tracking metric {cfg.metric!r}")
    if cfg.metric == "p2p":
        K = torch.as_tensor(cam.intrinsics, device=state.quat.device)
    b1, b2, eps = 0.9, 0.999, 1e-8
    dev = state.quat.device
    lr = torch.cat([torch.full((4,), cfg.lr_quat), torch.full((3,), cfg.lr_trans)]
                   ).to(device=dev, dtype=state.quat.dtype)
    im_h = d_h = None
    if cfg.keep_hist:
        im_h = torch.zeros((cfg.num_iters,), device=dev)
        d_h = torch.zeros((cfg.num_iters,), device=dev)
    s = state
    for i in range(cfg.num_iters):
        quat = s.quat.detach().requires_grad_(True)
        trans = s.trans.detach().requires_grad_(True)
        r = render_fn(quat, trans)
        out = loss_from_render(r, frame, cfg.loss_cfg, s.sil_thres,
                               s.count == 0, aux_mask)
        gq, gt = torch.autograd.grad(out.loss, (quat, trans))
        with torch.no_grad():
            g = torch.cat([gq, gt])
            count = s.count + 1
            t = torch.tensor(float(count), dtype=torch.float32)
            bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** t)
            bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** t)
            m = b1 * s.m + (1 - b1) * g
            v = b2 * s.v + (1 - b2) * g * g
            upd = lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            pose = torch.cat([s.quat, s.trans]) - upd
            new_quat, new_trans = pose[:4], pose[4:]
            loss = out.loss.detach()
            if cfg.metric == "loss":
                metric = loss
            else:
                metric = point2plane_metric(
                    p2p_target, frame.depth, K,
                    geo.pose_to_w2c(geo.normalize(new_quat), new_trans),
                    method=cfg.p2p_method)
            # a NaN metric neither becomes the best candidate nor freezes
            # the minimum at NaN
            better = metric < s.min_metric
            lower = loss < s.min_loss
            s = TrackState(
                quat=new_quat, trans=new_trans, m=m, v=v, count=count,
                best_quat=torch.where(better, new_quat, s.best_quat),
                best_trans=torch.where(better, new_trans, s.best_trans),
                min_metric=torch.where(better, metric, s.min_metric),
                min_loss=torch.where(lower, loss, s.min_loss),
                sil_thres=out.sil_thres_out.detach(),
                im_loss=out.im_loss.detach(),
                depth_loss=out.depth_loss.detach())
            if cfg.keep_hist:
                im_h[i] = s.im_loss
                d_h[i] = s.depth_loss
    return s, im_h, d_h


def track_frame(params: GaussianParams, active: torch.Tensor,
                state: TrackState, frame: Frame,
                aux_mask: torch.Tensor | None, cam: Camera,
                cfg: TrackingConfig, p2p_target: P2PTarget | None = None):
    """`track_loop` over the generic renderer (`render_slam`): every
    iteration projects, bins and blends from scratch (K4), and its pose
    gradient comes back through K5 and the projection by autograd."""
    bk = dict(cfg.loss_cfg.backend_kwargs)
    frozen = GaussianParams(*[x.detach() for x in params.tensors()])

    def render_fn(quat, trans):
        return render_slam(frozen, active, quat, trans, cam, bk)

    return track_loop(render_fn, state, frame, aux_mask, cfg, p2p_target, cam)


def track_frame_cached(cache, state: TrackState, frame: Frame,
                       aux_mask: torch.Tensor | None, cam: Camera,
                       cfg: TrackingConfig, p2p_target: P2PTarget | None = None):
    """`track_loop` over the frozen-binning renderer (core/track_cache.py):
    one K1 and one K2 launch per iteration, one of each per class for a
    two-class cache (`TrackCache2C`)."""
    from .track_cache import TrackCache2C, render_cached, render_cached_2c
    render = (render_cached_2c if isinstance(cache, TrackCache2C)
              else render_cached)

    def render_fn(quat, trans):
        return render(cache, quat, trans, cam)

    return track_loop(render_fn, state, frame, aux_mask, cfg, p2p_target, cam)


@torch.no_grad()
def probe_loss(params: GaussianParams, active: torch.Tensor,
               quat: torch.Tensor, trans: torch.Tensor, frame: Frame,
               cam: Camera, cfg: LossConfig, sil_thres: float,
               aux_mask: torch.Tensor | None = None):
    """One loss evaluation at a pose, no step (the ScanNet++ initial-error
    probe): (image loss, depth loss) as device scalars. Renders through
    `compute_loss` (render_slam: K4 on the card)."""
    out = compute_loss(params, active, quat, trans, frame, cam, cfg,
                       quat.new_tensor(sil_thres), True, aux_mask)
    return out.im_loss, out.depth_loss
