"""The public rasterizer API: `render` on the dense or the tiled route.

Parity: `vtgaussian_slam_tpu/ops/rasterizer/api.py` (the reference's
`GaussianRasterizer(raster_settings)(**rendervar)`). Colours may have any
channel count up to the blend's 8 on the tiled route (the SLAM layer
renders RGB with the (z, 1, z^2) depth / silhouette channels in one
pass); `active` masks capacity-padded buffers. The tiled route blends
through K4 on the card (and K5 under autograd); the dense route is the
O(N * H * W) reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..camera import Camera
from .dense import render_dense
from .tiled import render_tiled


class RenderOutput(NamedTuple):
    image: torch.Tensor   # (C, H, W)
    radii: torch.Tensor   # (N,) pixel radii; > 0 == "seen"


def render(means_cam: torch.Tensor, quats: torch.Tensor,
           scales: torch.Tensor, opacities: torch.Tensor,
           colors: torch.Tensor, cam: Camera,
           active: torch.Tensor | None = None, backend: str = "tiled",
           **kwargs) -> RenderOutput:
    if backend == "dense":
        img, radii = render_dense(means_cam, quats, scales, opacities, colors,
                                  cam, active, **kwargs)
    elif backend == "tiled":
        img, radii = render_tiled(means_cam, quats, scales, opacities, colors,
                                  cam, active, **kwargs)
    else:
        raise ValueError(f"unknown rasterizer backend {backend!r}")
    return RenderOutput(image=img, radii=radii)
