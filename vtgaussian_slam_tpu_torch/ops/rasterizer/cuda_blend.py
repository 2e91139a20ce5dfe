"""Record-space blend forward (K4) and backward (K5).

Replaces `vtgaussian_slam_tpu/ops/rasterizer/pallas_blend.py`:

  K4 `blend_forward`  <- `blend_tiles` / `_blend_fwd_impl` / `_fwd_kernel`
  K5 `blend_backward` <- `blend_tiles` / `_blend_bwd` / `_bwd_kernel`

The CUDA source is `csrc/blend.cu`, whose header says what bounds the
kernels on the H100. Each wrapper launches its kernel for CUDA tensors and
counts the launch in its `launches` attribute; the plain PyTorch versions
run only for tensors on the CPU. K4 feeds densification, evaluation and
every render of the generic tracking / mapping route; K5 is that route's
backward.

recs (n_tiles, 16, mpt) rows [mean2d.x mean2d.y conic.a conic.b conic.c
opacity colors(C <= 8) pad], counts (n_tiles,) -> (n_tiles, 256, C).
K5 returns (n_tiles, mpt, 16) record-row gradients [d mean2d, d conic,
d opacity, d colors, 0...] (row-major: the JAX kernel writes the transposed
(n_tiles, 16, mpt)), zero on every record no pixel walked. Pixels use
global coordinates and keep power <= 0 (K1 keeps <= 1e-3).
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
    `walked` marks the pairs the kernels evaluate (the record is live and
    the pixel still open when it reaches it), `blended` the pairs they
    composite, `weight` the blend weights."""
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
    expp = torch.exp(power)
    araw = op * expp
    alpha = torch.clamp(araw, max=ALPHA_MAX)
    in_count = (torch.arange(M, device=dev)[None, :]
                < counts.to(dev)[:, None])[:, None, :]
    keep = (power <= 0) & (alpha >= ALPHA_MIN) & in_count
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    T_after = torch.cumprod(1.0 - alpha, dim=-1)
    T_in = torch.cat([torch.ones_like(T_after[..., :1]), T_after[..., :-1]], -1)
    include = T_after >= T_TERMINATE
    weight = torch.where(include, alpha * T_in, torch.zeros_like(alpha))
    return dict(walked=in_count & (T_in >= T_TERMINATE), blended=keep & include,
                weight=weight, dx=dx, dy=dy, expp=expp, alpha=alpha,
                clamped=araw > ALPHA_MAX, T_in=T_in)


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


def blend_backward_plain(recs: torch.Tensor, counts: torch.Tensor,
                         out: torch.Tensor, g: torch.Tensor, tiles_x: int,
                         tile_ids=None) -> torch.Tensor:
    """Plain K5: the walk's suffix-identity gradients -> (T, mpt, 16)."""
    T, _, M = recs.shape
    C = out.shape[-1]
    if tile_ids is None:
        tile_ids = torch.arange(T, device=recs.device)
    w = _blend_walk(recs, counts, tiles_x, tile_ids)
    cols = recs[:, 6:6 + C]                                     # (T, C, M)
    GG = (g * out).sum(-1)[..., None]                           # (T, P, 1)
    Gc = torch.einsum("tpc,tcm->tpm", g, cols)
    Hk = torch.cumsum(w["weight"] * Gc, dim=-1)
    inv_om = 1.0 / torch.clamp(1.0 - w["alpha"], min=1e-6)
    ga = torch.where(w["blended"] & ~w["clamped"],
                     w["T_in"] * Gc - (GG - Hk) * inv_om, torch.zeros_like(Gc))
    gp = ga * w["alpha"]
    dx, dy = w["dx"], w["dy"]
    s_dx, s_dy = (gp * dx).sum(1), (gp * dy).sum(1)              # (T, M)
    ca, cb, cc = recs[:, 2], recs[:, 3], recs[:, 4]
    rows = torch.stack([ca * s_dx + cb * s_dy, cc * s_dy + cb * s_dx,
                        -0.5 * (gp * dx * dx).sum(1), -(gp * dx * dy).sum(1),
                        -0.5 * (gp * dy * dy).sum(1), (ga * w["expp"]).sum(1)],
                       -1)
    g_cols = torch.einsum("tpm,tpc->tmc", w["weight"], g)
    return torch.cat([rows, g_cols, rows.new_zeros((T, M, RECW - 6 - C))],
                     -1).contiguous()


def blend_backward(recs: torch.Tensor, counts: torch.Tensor, out: torch.Tensor,
                   g: torch.Tensor, tiles_x: int) -> torch.Tensor:
    """K5: replay the walk -> (T, mpt, 16) per-record gradient rows."""
    if recs.device.type == "cpu":
        return blend_backward_plain(recs, counts, out, g, tiles_x)
    g = g.contiguous()
    T, _, M = recs.shape
    C = out.shape[-1] if out.dim() == 3 else 0
    _build.require(recs.dtype == torch.float32 and recs.dim() == 3
                   and recs.shape[1] == RECW and recs.is_contiguous() and T >= 1,
                   f"recs must be contiguous f32 (T, 16, mpt), got "
                   f"{tuple(recs.shape)} {recs.dtype}")
    _build.require(counts.dtype == torch.int32 and counts.shape == (T,)
                   and counts.is_contiguous() and counts.device == recs.device,
                   "counts must be contiguous int32 (T,) on the records' device")
    _build.require(1 <= C <= 8, "1 <= n_channels <= 8")
    for t in (out, g):
        _build.require(t.dtype == torch.float32 and t.shape == (T, TPX, C)
                       and t.is_contiguous() and t.device == recs.device,
                       "accum / cotangent must be contiguous f32 (T, 256, C)")
    grad = torch.empty((T, M, RECW), dtype=torch.float32, device=recs.device)
    lib = _build.library("blend")
    err = lib.vtgs_blend_bwd(recs.data_ptr(), counts.data_ptr(), out.data_ptr(),
                             g.data_ptr(), T, M, tiles_x, C, grad.data_ptr(),
                             _build.stream_of(recs))
    _build.check(lib, err, "vtgs_blend_bwd launch")
    blend_backward.launches += 1
    return grad


blend_backward.launches = 0
