"""Record-space blend forward, kernel K4.

Replaces `vtgaussian_slam_tpu/ops/rasterizer/pallas_blend.py`
(`blend_tiles` -> `_blend_fwd_impl` -> `_fwd_kernel`); the CUDA source is
`csrc/blend.cu`, whose header says what bounds it on the H100. The wrapper
launches the kernel for CUDA tensors and counts the launch in
`blend_forward.launches`; the plain PyTorch version runs only for tensors
on the CPU. The blend backward (K5) is off this slice's path.

recs (n_tiles, 16, mpt) rows [mean2d.x mean2d.y conic.a conic.b conic.c
opacity colors(C <= 8) pad], counts (n_tiles,) -> (n_tiles, 256, C).
Pixels use global coordinates and keep power <= 0 (K1 keeps <= 1e-3).
"""
from __future__ import annotations

import torch

from . import _build
from .blend import ALPHA_MAX, ALPHA_MIN, T_TERMINATE

RECW = 16
TILE = 16
TPX = TILE * TILE


def _blend_walk(recs, counts, tiles_x, tile_ids):
    """Every (tile, pixel, record) quantity of the front-to-back walk:
    `walked` marks the pairs the kernel evaluates (the record is live and
    the pixel still open when it reaches it), `weight` the blend weights."""
    T, _, M = recs.shape
    dev = recs.device
    lin = torch.arange(TPX, device=dev)
    px = ((tile_ids % tiles_x)[:, None] * TILE + lin % TILE).float()[..., None]
    py = ((tile_ids // tiles_x)[:, None] * TILE + lin // TILE).float()[..., None]
    m2x, m2y = recs[:, None, 0], recs[:, None, 1]
    ca, cb, cc, op = (recs[:, None, i] for i in (2, 3, 4, 5))
    dx = px - m2x                                            # (T, P, M)
    dy = py - m2y
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = torch.clamp(op * torch.exp(power), max=ALPHA_MAX)
    in_count = (torch.arange(M, device=dev)[None, :]
                < counts.to(dev)[:, None])[:, None, :]
    keep = (power <= 0) & (alpha >= ALPHA_MIN) & in_count
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    T_after = torch.cumprod(1.0 - alpha, dim=-1)
    T_in = torch.cat([torch.ones_like(T_after[..., :1]), T_after[..., :-1]], -1)
    include = T_after >= T_TERMINATE
    weight = torch.where(include, alpha * T_in, torch.zeros_like(alpha))
    return dict(walked=in_count & (T_in >= T_TERMINATE), blended=keep & include,
                weight=weight)


def blend_forward_plain(recs: torch.Tensor, counts: torch.Tensor, tiles_x: int,
                        n_channels: int = 8, tile_ids=None) -> torch.Tensor:
    """Plain K4, vectorised over (tiles, pixels, records)."""
    if tile_ids is None:
        tile_ids = torch.arange(recs.shape[0], device=recs.device)
    w = _blend_walk(recs, counts, tiles_x, tile_ids)
    return torch.einsum("tpm,tcm->tpc", w["weight"], recs[:, 6:6 + n_channels])


def blend_forward(recs: torch.Tensor, counts: torch.Tensor, tiles_x: int,
                  n_channels: int = 8) -> torch.Tensor:
    """K4: composite depth-ordered records per tile -> (T, 256, C)."""
    if recs.device.type == "cpu":
        return blend_forward_plain(recs, counts, tiles_x, n_channels)
    T = recs.shape[0]
    _build.require(recs.dtype == torch.float32 and recs.dim() == 3
                   and recs.shape[1] == RECW and recs.is_contiguous() and T >= 1,
                   f"recs must be contiguous f32 (T, 16, mpt), got "
                   f"{tuple(recs.shape)} {recs.dtype}")
    _build.require(counts.dtype == torch.int32 and counts.shape == (T,)
                   and counts.is_contiguous() and counts.device == recs.device,
                   "counts must be contiguous int32 (T,) on the records' device")
    _build.require(1 <= n_channels <= 8, "1 <= n_channels <= 8")
    out = torch.empty((T, TPX, n_channels), dtype=torch.float32,
                      device=recs.device)
    lib = _build.library("blend")
    err = lib.vtgs_blend_fwd(recs.data_ptr(), counts.data_ptr(), T,
                             recs.shape[2], tiles_x, n_channels, out.data_ptr(),
                             _build.stream_of(recs))
    _build.check(lib, err, "vtgs_blend_fwd launch")
    blend_forward.launches += 1
    return out


blend_forward.launches = 0
