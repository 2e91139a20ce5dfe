"""The mapping loss in one kernel: colour L1 + SSIM and the masked depth L1
of a render against its keyframe, with its gradient to the render's colour
and depth.

`map_loss(im, depth, depth_sq, gt_im, gt_depth, im_weight, depth_weight)`
returns (loss, im_loss, depth_loss), the mapping branch of
`core.losses.loss_from_render` without outlier rejection or an auxiliary
mask:

    im_loss    = 0.8 mean|im - gt_im| + 0.2 (1 - ssim(im, gt_im))
    depth_loss = sum|m (gt_depth - depth)| / max(sum m, 1),
                 m = (gt_depth > 0) & ~isnan(depth) & ~isnan(depth_sq - depth^2)
    loss       = im_weight im_loss + depth_weight depth_loss

differentiable in `im` and `depth` (not in `depth_sq`), for CUDA tensors
only: `loss_from_render` keeps its PyTorch ops everywhere else, and the
card tests hold the kernel to them. It launches `csrc/maploss.cu` (whose
header gives the algebra and what bounds it): the forward tiles and the
fixed-order reduction, then, in the backward, one scaling pass; nothing is
read back to the host, and under `torch.no_grad` the forward writes no
gradient. The colour planes may be strided views (the render's planes of
the assembled tile image) as long as their columns are contiguous.
"""
from __future__ import annotations

import torch

from .rasterizer import _build

TILE = 32   # the kernel's output tile side (csrc/maploss.cu TW, TH)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """`t` with contiguous columns (a copy only where they are not)."""
    return t if t.stride(-1) == 1 else t.contiguous()


def map_loss_forward(im, depth, depth_sq, gt_im, gt_depth, im_weight: float,
                     depth_weight: float, grad: bool):
    """The forward kernels: (loss, im_loss, depth_loss, max(sum m, 1)) as
    0-d device tensors, and with `grad` the gradient numerators (g_im
    (3, H, W): d im_loss / d im; g_d (1, H, W): -sign(gt_depth - depth) m),
    else (None, None)."""
    _build.require(im.is_cuda, f"the mapping-loss kernel takes CUDA "
                   f"tensors, got {im.device}")
    _, H, W = im.shape
    for name, t, c in (("im", im, 3), ("gt_im", gt_im, 3), ("depth", depth, 1),
                       ("depth_sq", depth_sq, 1), ("gt_depth", gt_depth, 1)):
        _build.require(t.dtype == torch.float32 and t.shape == (c, H, W)
                       and t.device == im.device,
                       f"{name} must be f32 ({c}, {H}, {W}) on {im.device}, "
                       f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    im, gt_im, depth, depth_sq, gt_depth = (
        _rows(t.detach()) for t in (im, gt_im, depth, depth_sq, gt_depth))
    dev = im.device
    n_part = 3 * (-(-H // TILE)) * (-(-W // TILE))
    part = torch.empty((n_part, 3), dtype=torch.float32, device=dev)
    part_n = torch.empty((n_part,), dtype=torch.int32, device=dev)
    loss, im_loss, depth_loss, denom = (
        torch.empty((), dtype=torch.float32, device=dev) for _ in range(4))
    g_im = torch.empty((3, H, W), dtype=torch.float32, device=dev) if grad \
        else None
    g_d = torch.empty((1, H, W), dtype=torch.float32, device=dev) if grad \
        else None
    lib = _build.library("maploss")
    err = lib.vtgs_map_loss_fwd(
        im.data_ptr(), gt_im.data_ptr(), depth.data_ptr(),
        depth_sq.data_ptr(), gt_depth.data_ptr(), H, W,
        im.stride(0), im.stride(1), gt_im.stride(0), gt_im.stride(1),
        depth.stride(1), depth_sq.stride(1), gt_depth.stride(1),
        float(im_weight), float(depth_weight), part.data_ptr(),
        part_n.data_ptr(), g_im.data_ptr() if grad else None,
        g_d.data_ptr() if grad else None, loss.data_ptr(),
        im_loss.data_ptr(), depth_loss.data_ptr(), denom.data_ptr(),
        _build.stream_of(im))
    _build.check(lib, err, "vtgs_map_loss_fwd launch")
    _build.count_launch(map_loss_forward)
    return loss, im_loss, depth_loss, denom, g_im, g_d


map_loss_forward.launches = 0


def map_loss_backward(g, denom, g_im, g_d, im_weight: float,
                      depth_weight: float):
    """The backward kernel: (d im, d depth) = (g im_weight g_im,
    g depth_weight g_d / denom), `g` and `denom` read on the device."""
    _, H, W = g_im.shape
    g = g.reshape(1).contiguous()
    d_im = torch.empty_like(g_im)
    d_depth = torch.empty_like(g_d)
    lib = _build.library("maploss")
    err = lib.vtgs_map_loss_bwd(g.data_ptr(), denom.data_ptr(),
                                float(im_weight), float(depth_weight),
                                g_im.data_ptr(), g_d.data_ptr(), H, W,
                                d_im.data_ptr(), d_depth.data_ptr(),
                                _build.stream_of(g_im))
    _build.check(lib, err, "vtgs_map_loss_bwd launch")
    _build.count_launch(map_loss_backward)
    return d_im, d_depth


map_loss_backward.launches = 0


class MapLoss(torch.autograd.Function):
    """(loss, im_loss, depth_loss) by the forward kernels; the backward
    scales the saved numerators (`map_loss_backward`). im_loss and
    depth_loss carry no gradient."""

    @staticmethod
    def forward(ctx, im, depth, depth_sq, gt_im, gt_depth, im_weight,
                depth_weight, grad):
        loss, im_loss, depth_loss, denom, g_im, g_d = map_loss_forward(
            im, depth, depth_sq, gt_im, gt_depth, im_weight, depth_weight,
            grad)
        ctx.mark_non_differentiable(im_loss, depth_loss)
        if grad:
            ctx.save_for_backward(g_im, g_d, denom)
        ctx.weights = (im_weight, depth_weight)
        return loss, im_loss, depth_loss

    @staticmethod
    def backward(ctx, g, _g_im_loss, _g_depth_loss):
        g_im, g_d, denom = ctx.saved_tensors
        d_im, d_depth = map_loss_backward(g, denom, g_im, g_d, *ctx.weights)
        return d_im, d_depth, None, None, None, None, None, None


def map_loss(im, depth, depth_sq, gt_im, gt_depth, im_weight: float,
             depth_weight: float):
    """(loss, im_loss, depth_loss) by the kernels, on CUDA tensors."""
    grad = torch.is_grad_enabled() and (im.requires_grad
                                        or depth.requires_grad)
    return MapLoss.apply(im, depth, depth_sq, gt_im, gt_depth,
                         float(im_weight), float(depth_weight), grad)
