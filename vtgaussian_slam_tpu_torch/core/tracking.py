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

Every loop steps through `track_step`: the Adam bias corrections come
from a device table indexed by a device counter that the step advances,
so an iteration holds no value that changes on the host. On a card,
`track_frame_cached` (the single-card frozen-binning renderer) therefore
runs a call's first iteration eagerly, captures the second into a CUDA
graph and replays it for the rest: one graph launch an iteration instead
of ~250 kernel launches from Python and autograd, the same kernels on
the same operands in the same order, so the same bits. The generic route
(`track_frame`) and the tile-sharded loop call `track_loop`, which stays
eager.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..models.gaussians import GaussianParams
from ..ops import geometry as geo
from ..ops.camera import Camera
from ..ops.rasterizer import _build
from .losses import (Frame, LossConfig, LossOutput, compute_loss,
                     loss_from_render, render_slam)
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


B1, B2, EPS = 0.9, 0.999, 1e-8     # Adam's betas and epsilon
_TENSORS = ("quat", "trans", "m", "v", "best_quat", "best_trans",
            "min_metric", "min_loss", "sil_thres", "im_loss", "depth_loss")


def bias_corrections(n: int) -> torch.Tensor:
    """(n, 2) f32 rows [1 - b1^t, 1 - b2^t] for steps t = 1..n, each the
    f32 power of an f32 beta taken on the host."""
    b1 = torch.tensor(B1, dtype=torch.float32)
    b2 = torch.tensor(B2, dtype=torch.float32)
    rows = []
    for t in range(1, n + 1):
        tt = torch.tensor(float(t), dtype=torch.float32)
        rows.append(torch.stack([1 - b1 ** tt, 1 - b2 ** tt]))
    return torch.stack(rows)


_FACTORS: dict = {}    # device -> (N, 2) step factors of steps 1..N


def step_factors(device: torch.device, first: int, n: int) -> torch.Tensor:
    """The f32 reciprocals of the bias corrections of steps first+1 ..
    first+n, which `track_step` multiplies by. PyTorch divides a card
    tensor by a host float as a product with the float's f32 reciprocal,
    so on a card the step keeps the bits of the loop that divided by host
    floats; on the CPU, which divided, it may differ from that loop by an
    ulp. Uploaded once per device and grown as longer calls need."""
    tab = _FACTORS.get(device)
    if tab is None or tab.shape[0] < first + n:
        size = max(256, 1 << (first + n - 1).bit_length())
        bc = bias_corrections(size)
        tab = _FACTORS[device] = (torch.ones_like(bc) / bc).to(device)
    return tab[first:first + n]


class LoopConsts(NamedTuple):
    """What one tracking call holds fixed over its iterations, on the
    pose's device: the learning rates, the bias-correction factors, the
    iteration counter `k` that `track_step` advances, the loss streams it
    writes at `k` (None without `keep_hist`), and for "p2p" the target and
    the intrinsics."""
    lr: torch.Tensor               # (7,) [quat x 4, trans x 3]
    factors: torch.Tensor          # (num_iters, 2), `step_factors`
    k: torch.Tensor                # (1,) int64
    im_h: torch.Tensor | None      # (num_iters,)
    d_h: torch.Tensor | None
    p2p_target: P2PTarget | None
    K: torch.Tensor | None         # (3, 3)


def loop_consts(state: TrackState, cfg: TrackingConfig,
                p2p_target: P2PTarget | None = None,
                cam: Camera | None = None) -> LoopConsts:
    if cfg.metric not in ("loss", "p2p"):
        raise ValueError(f"unknown tracking metric {cfg.metric!r}")
    dev = state.quat.device
    lr = torch.cat([torch.full((4,), cfg.lr_quat), torch.full((3,), cfg.lr_trans)]
                   ).to(device=dev, dtype=state.quat.dtype)
    im_h = d_h = None
    if cfg.keep_hist:
        im_h = torch.zeros((cfg.num_iters,), device=dev)
        d_h = torch.zeros((cfg.num_iters,), device=dev)
    K = None
    if cfg.metric == "p2p":
        K = torch.as_tensor(cam.intrinsics, device=dev)
    return LoopConsts(lr=lr, factors=step_factors(dev, state.count,
                                                  cfg.num_iters),
                      k=torch.zeros((1,), dtype=torch.int64, device=dev),
                      im_h=im_h, d_h=d_h, p2p_target=p2p_target, K=K)


@torch.no_grad()
def track_step(s: TrackState, out: LossOutput, gq: torch.Tensor,
               gt: torch.Tensor, frame: Frame, cfg: TrackingConfig,
               lc: LoopConsts) -> TrackState:
    """One Adam step on (quat, trans) from the loss `out` at `s` and its
    pose gradient, the best-candidate bookkeeping, the loss streams'
    entry, and `lc.k` advanced: every value on the device, none read."""
    f = lc.factors.index_select(0, lc.k)[0]
    g = torch.cat([gq, gt])
    m = B1 * s.m + (1 - B1) * g
    v = B2 * s.v + (1 - B2) * g * g
    upd = lc.lr * (m * f[0]) / (torch.sqrt(v * f[1]) + EPS)
    pose = torch.cat([s.quat, s.trans]) - upd
    new_quat, new_trans = pose[:4], pose[4:]
    loss = out.loss.detach()
    if cfg.metric == "loss":
        metric = loss
    else:
        metric = point2plane_metric(
            lc.p2p_target, frame.depth, lc.K,
            geo.pose_to_w2c(geo.normalize(new_quat), new_trans),
            method=cfg.p2p_method)
    # a NaN metric neither becomes the best candidate nor freezes the
    # minimum at NaN
    better = metric < s.min_metric
    lower = loss < s.min_loss
    new = TrackState(
        quat=new_quat, trans=new_trans, m=m, v=v, count=s.count + 1,
        best_quat=torch.where(better, new_quat, s.best_quat),
        best_trans=torch.where(better, new_trans, s.best_trans),
        min_metric=torch.where(better, metric, s.min_metric),
        min_loss=torch.where(lower, loss, s.min_loss),
        sil_thres=out.sil_thres_out.detach(),
        im_loss=out.im_loss.detach(), depth_loss=out.depth_loss.detach())
    if lc.im_h is not None:
        lc.im_h.index_copy_(0, lc.k, new.im_loss.reshape(1))
        lc.d_h.index_copy_(0, lc.k, new.depth_loss.reshape(1))
    lc.k.add_(1)
    return new


def track_iteration(render_fn, s: TrackState, frame: Frame,
                    aux_mask: torch.Tensor | None, cfg: TrackingConfig,
                    lc: LoopConsts) -> TrackState:
    """Render at `s`'s pose, take the masked loss and its pose gradient,
    and step (`track_step`)."""
    quat = s.quat.detach().requires_grad_(True)
    trans = s.trans.detach().requires_grad_(True)
    r = render_fn(quat, trans)
    out = loss_from_render(r, frame, cfg.loss_cfg, s.sil_thres,
                           s.count == 0, aux_mask)
    gq, gt = torch.autograd.grad(out.loss, (quat, trans))
    return track_step(s, out, gq, gt, frame, cfg, lc)


def track_loop(render_fn, state: TrackState, frame: Frame,
               aux_mask: torch.Tensor | None, cfg: TrackingConfig,
               p2p_target: P2PTarget | None = None, cam: Camera | None = None):
    """The tracking optimization loop over a pose-differentiable renderer
    `render_fn(quat, trans) -> RenderResult`, every iteration launched from
    Python. Metric "p2p" needs the overlap frame's `p2p_target` and the
    camera. Returns (state, im_hist, depth_hist) with the per-iteration
    loss streams (None, None when `cfg.keep_hist` is off)."""
    lc = loop_consts(state, cfg, p2p_target, cam)
    s = state
    for _ in range(cfg.num_iters):
        s = track_iteration(render_fn, s, frame, aux_mask, cfg, lc)
    return s, lc.im_h, lc.d_h


def graph_engages(device: torch.device, num_iters: int) -> bool:
    """Whether `track_frame_cached` replays a CUDA graph: on a card, for a
    call of two iterations or more (the first runs eagerly)."""
    return device.type == "cuda" and num_iters >= 2


class GraphedCalls:
    """What graphed tracking calls keep in the process: per device the
    stream they run on and the last call's graph, whose private memory
    pool the next capture shares; and `replays`, the iterations served by
    replay so far (the engine's `track.graph_iters` counter)."""

    def __init__(self):
        self.streams: dict = {}
        self.last: dict = {}
        self.replays = 0

    def stream(self, dev: torch.device) -> torch.cuda.Stream:
        if dev not in self.streams:
            self.streams[dev] = torch.cuda.Stream(dev)
        return self.streams[dev]


GRAPHED = GraphedCalls()


def _copy_state(dst: TrackState, src: TrackState) -> None:
    for name in _TENSORS:
        getattr(dst, name).copy_(getattr(src, name))


def track_loop_graphed(render_fn, state: TrackState, frame: Frame,
                       aux_mask: torch.Tensor | None, cfg: TrackingConfig,
                       p2p_target: P2PTarget | None = None,
                       cam: Camera | None = None):
    """`track_loop` on a card, `cfg.num_iters` >= 2: the first iteration
    eagerly (it picks the silhouette threshold at count 0 and warms up
    autograd, the allocator and cuBLAS on the stream the graph is captured
    on), the second captured into a CUDA graph, and the graph replayed for
    iterations 2..num_iters. The state lives in buffers the graph reads
    and updates in place; the renderer's operands, the frame, `aux_mask`
    and the p2p target are read where they lie, and the caller keeps them
    for the call. The graph's private memory pool is shared with the
    previous call's graph, which is then dropped: PyTorch frees a released
    pool's memory only on `empty_cache`, so a pool per call would pile
    up. The kernel wrappers count each replay's launches."""
    n = cfg.num_iters
    dev = state.quat.device
    lc = loop_consts(state, cfg, p2p_target, cam)
    held = TrackState(count=state.count + 1, **{
        name: torch.empty_like(getattr(state, name)) for name in _TENSORS})
    cur = torch.cuda.current_stream(dev)
    side = GRAPHED.stream(dev)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        _copy_state(held, track_iteration(render_fn, state, frame, aux_mask,
                                          cfg, lc))
        graph = torch.cuda.CUDAGraph()
        last = GRAPHED.last.get(dev)
        launches = _build.CapturedLaunches()
        graph.capture_begin(pool=None if last is None else last.pool())
        try:
            with launches:
                _copy_state(held, track_iteration(render_fn, held, frame,
                                                  aux_mask, cfg, lc))
        finally:
            graph.capture_end()
        GRAPHED.last[dev] = graph
        del last
        for _ in range(n - 1):
            launches.replay(graph)
    cur.wait_stream(side)
    GRAPHED.replays += n - 1
    held.count = state.count + n
    return held, lc.im_h, lc.d_h


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
    one K1 and one K2 launch per iteration. Where `graph_engages` (a card,
    two iterations or more) iterations 2..num_iters replay a CUDA graph
    (`track_loop_graphed`); `GRAPHED.replays` counts the iterations served
    so."""
    from .track_cache import render_cached

    def render_fn(quat, trans):
        return render_cached(cache, quat, trans, cam)

    if graph_engages(state.quat.device, cfg.num_iters):
        return track_loop_graphed(render_fn, state, frame, aux_mask, cfg,
                                  p2p_target, cam)
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
