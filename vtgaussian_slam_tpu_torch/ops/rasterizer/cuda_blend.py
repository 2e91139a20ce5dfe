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

Both wrappers take `tile_ids` / `tile_offset` as cuda_splat's do (the
tile-sharded `parallel.sharded_render` renders a rank's rows at its
offset).

recs (n_tiles, 16, mpt) rows [mean2d.x mean2d.y conic.a conic.b conic.c
opacity colors(C <= 8) pad], counts (n_tiles,) -> (n_tiles, 256, C).
K5 returns (n_tiles, mpt, 16) record-row gradients [d mean2d, d conic,
d opacity, d colors, 0...] (row-major: the JAX kernel writes the transposed
(n_tiles, 16, mpt)), zero on every record no pixel walked. Pixels use
global coordinates and keep power <= 0 (K1 keeps <= 1e-3).

Beside the plain versions stand mirrors of what only the kernels do on the
card, for the CPU tests alone: `record_box` (the per-record cull box of K4
and K5), `blend_forward_grouped` (K4's box cull, compacted live list and
grouped select blends) and `backward_sums_tf32` (K5's split tensor-core
products and moment epilogue).
"""
from __future__ import annotations

import torch

from . import _build
from .blend import ALPHA_MAX, ALPHA_MIN, T_TERMINATE
from .cuda_splat import (_split_tf32, block_pixels, box_meets_blocks,
                         box_radius2, check_tile_ids, cull_boxes, image_tiles,
                         pixel_moment_basis, unblock_pixels)

RECW = 16
TILE = 16
TPX = TILE * TILE
NWARP = TPX // 32


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
    return dict(walked=in_count & (T_in >= T_TERMINATE), keep=keep,
                blended=keep & include, weight=weight, dx=dx, dy=dy,
                expp=expp, alpha=alpha,
                clamped=araw > ALPHA_MAX, T_in=T_in)


def blend_forward_plain(recs: torch.Tensor, counts: torch.Tensor, tiles_x: int,
                        n_channels: int = 8, tile_ids=None) -> torch.Tensor:
    """Plain K4, vectorised over (tiles, pixels, records)."""
    if tile_ids is None:
        tile_ids = torch.arange(recs.shape[0], device=recs.device)
    w = _blend_walk(recs, counts, tiles_x, tile_ids)
    return torch.einsum("tpm,tcm->tpc", w["weight"], recs[:, 6:6 + n_channels])


def blend_forward(recs: torch.Tensor, counts: torch.Tensor, tiles_x: int,
                  n_channels: int = 8, tile_ids: torch.Tensor | None = None,
                  tile_offset: int = 0) -> torch.Tensor:
    """K4: composite depth-ordered records per tile -> (T, 256, C). Row r
    renders the image tile `tile_ids[r]` (default r) + `tile_offset`."""
    T = recs.shape[0]
    if recs.device.type == "cpu":
        return blend_forward_plain(recs, counts, tiles_x, n_channels,
                                   image_tiles(T, tile_ids, tile_offset,
                                               recs.device))
    _build.require(recs.dtype == torch.float32 and recs.dim() == 3
                   and recs.shape[1] == RECW and recs.is_contiguous() and T >= 1,
                   f"recs must be contiguous f32 (T, 16, mpt), got "
                   f"{tuple(recs.shape)} {recs.dtype}")
    _build.require(counts.dtype == torch.int32 and counts.shape == (T,)
                   and counts.is_contiguous() and counts.device == recs.device,
                   "counts must be contiguous int32 (T,) on the records' device")
    _build.require(1 <= n_channels <= 8, "1 <= n_channels <= 8")
    tids = check_tile_ids(tile_ids, T, recs.device)
    out = torch.empty((T, TPX, n_channels), dtype=torch.float32,
                      device=recs.device)
    lib = _build.library("blend")
    err = lib.vtgs_blend_fwd(recs.data_ptr(), counts.data_ptr(), tids, T,
                             recs.shape[2], tiles_x, int(tile_offset),
                             n_channels, out.data_ptr(), _build.stream_of(recs))
    _build.check(lib, err, "vtgs_blend_fwd launch")
    _build.count_launch(blend_forward)
    return out


blend_forward.launches = 0


def _tile_origin(tile_ids, tiles_x):
    return (((tile_ids % tiles_x) * TILE).float()[:, None],
            ((tile_ids // tiles_x) * TILE).float()[:, None])


def record_box(recs, tiles_x, tile_ids=None):
    """K4's and K5's per-record cull box (`record_box` of csrc/blend.cu),
    (T, mpt, 4) [xlo, xhi, ylo, yhi] in tile-local pixel coordinates, from
    the record alone: for the conic (a, b, c) with det = ac - b^2 > 0 the
    extent of Q <= box_radius2(op) is sqrt(r2 c / det) by sqrt(r2 a / det)
    about the mean. det is lowered by a bound on its own rounding, which
    only widens the box; det <= 0 or an extent that is not finite gives
    the whole tile (no cull), opacity < 1/255 an empty box."""
    if tile_ids is None:
        tile_ids = torch.arange(recs.shape[0], device=recs.device)
    tox, toy = _tile_origin(tile_ids, tiles_x)
    mx, my = recs[:, 0] - tox, recs[:, 1] - toy
    ca, cb, cc, op = recs[:, 2], recs[:, 3], recs[:, 4], recs[:, 5]
    has_box = op >= ALPHA_MIN
    r2 = box_radius2(torch.where(has_box, op, torch.ones_like(op)))
    ac, bb = ca * cc, cb * cb
    det = (ac - bb) - 1e-6 * (ac.abs() + bb)
    hx, hy = torch.sqrt(r2 * cc / det), torch.sqrt(r2 * ca / det)
    whole = ~(det > 0) | ~(hx <= 3e38) | ~(hy <= 3e38)
    return cull_boxes(mx, my, hx, hy, has_box, whole)


def blend_forward_grouped(recs, counts, tiles_x, n_channels=8, tile_ids=None,
                          ng=4, chunk=256):
    """K4's walk in plain PyTorch (the tests use it; no engine path does):
    per `chunk` records, each warp's 8 x 4 pixel block compacts the records
    whose box meets it into a list in record order; its pixels evaluate the
    list `ng` records at a time (alpha does not depend on the walk's
    state; a last group's missing entries are kept by no pixel) and blend
    them front to back with selects; a pixel stops at the first record
    whose transmittance after blending would fall below 1e-4. Returns
    (T, 256, C) like `blend_forward_plain`."""
    T, _, M = recs.shape
    dev = recs.device
    if tile_ids is None:
        tile_ids = torch.arange(T, device=dev)
    w = _blend_walk(recs, counts, tiles_x, tile_ids)
    in_count = torch.arange(M, device=dev)[None] < counts.to(dev)[:, None]
    live = (box_meets_blocks(record_box(recs, tiles_x, tile_ids))
            & in_count[:, None])                                # (T, 8, M)
    alpha = block_pixels(w["alpha"])                            # (T, 8, 32, M)
    keep = block_pixels(w["keep"])
    cols = recs[:, 6:6 + n_channels].transpose(1, 2)            # (T, M, C)
    Tr = torch.ones((T, NWARP, 32), device=dev)
    done = torch.zeros((T, NWARP, 32), dtype=torch.bool, device=dev)
    acc = torch.zeros((T, NWARP, 32, n_channels), device=dev)
    zero = torch.zeros((), device=dev)
    tt = torch.arange(T, device=dev)[:, None, None]
    for c0 in range(0, M, chunk):
        lv = live[..., c0:c0 + chunk]
        # the warp's list: its live records first, in record order
        order = torch.argsort((~lv).to(torch.uint8), dim=-1, stable=True)
        L = lv.sum(-1)                                          # (T, 8)
        for i0 in range(0, int(L.max()), ng):
            idx = c0 + order[..., i0:i0 + ng]                   # (T, 8, g)
            g = idx.shape[-1]
            in_list = i0 + torch.arange(g, device=dev) < L[..., None]
            at = idx[:, :, None, :].expand(T, NWARP, 32, g)
            al_g = torch.take_along_dim(alpha, at, -1)
            kp_g = torch.take_along_dim(keep, at, -1) & in_list[:, :, None]
            col_g = cols[tt, idx]                               # (T, 8, g, C)
            for j in range(g):
                al = al_g[..., j]
                kp = kp_g[..., j] & ~done
                Ta = Tr * (1.0 - al)
                stop = kp & (Ta < T_TERMINATE)
                blend = kp & ~stop
                done = done | stop
                wgt = torch.where(blend, al * Tr, zero)
                acc = acc + wgt[..., None] * col_g[:, :, None, j]
                Tr = torch.where(blend, Ta, Tr)
    return unblock_pixels(acc)


def _backward_pairs(recs, counts, out, g, tiles_x, tile_ids):
    """Replay the walk: (walk, d alpha, d power = d alpha * alpha) per
    (tile, pixel, record), zero where the pair was not blended."""
    w = _blend_walk(recs, counts, tiles_x, tile_ids)
    cols = recs[:, 6:6 + out.shape[-1]]                         # (T, C, M)
    GG = (g * out).sum(-1)[..., None]                           # (T, P, 1)
    Gc = torch.einsum("tpc,tcm->tpm", g, cols)
    Hk = torch.cumsum(w["weight"] * Gc, dim=-1)
    inv_om = 1.0 / torch.clamp(1.0 - w["alpha"], min=1e-6)
    ga = torch.where(w["blended"] & ~w["clamped"],
                     w["T_in"] * Gc - (GG - Hk) * inv_om, torch.zeros_like(Gc))
    return w, ga, ga * w["alpha"]


def _backward_sums(recs, counts, out, g, tiles_x, tile_ids):
    """The per-record sums over the tile's pixels, taken directly."""
    w, ga, gp = _backward_pairs(recs, counts, out, g, tiles_x, tile_ids)
    dx, dy = w["dx"], w["dy"]
    return dict(s_dx=(gp * dx).sum(1), s_dy=(gp * dy).sum(1),
                s_dxx=(gp * dx * dx).sum(1), s_dxy=(gp * dx * dy).sum(1),
                s_dyy=(gp * dy * dy).sum(1), s_ge=(ga * w["expp"]).sum(1),
                g_cols=torch.einsum("tpm,tpc->tmc", w["weight"], g))


def backward_sums_tf32(recs, counts, out, g, tiles_x, tile_ids=None):
    """K5's reduction in plain PyTorch (the tests use it; no engine path
    does): the sums of `_backward_sums` as the tensor-core products
    Mg = GP . PHI over the pixel moments about the tile centre and
    Mw = W . GC over the cotangent columns, on operands rounded to TF32 and
    split a = hi + lo (GP . PHI as hi + lo, PHI being exact; W . GC as
    hi.hi + hi.lo + lo.hi), then the epilogue that rebuilds the dx / dy
    sums from the moments about the record mean and sum galpha exp(power)
    = M5 / opacity."""
    if tile_ids is None:
        tile_ids = torch.arange(recs.shape[0], device=recs.device)
    w, _, gp = _backward_pairs(recs, counts, out, g, tiles_x, tile_ids)
    phi = pixel_moment_basis(recs.device)
    gh, gl = _split_tf32(gp)
    Mg = (torch.einsum("tpm,pc->tmc", gl, phi)
          + torch.einsum("tpm,pc->tmc", gh, phi))               # (T, M, 6)
    wh, wl = _split_tf32(w["weight"])
    ch, cl = _split_tf32(g)
    Mw = (torch.einsum("tpm,tpc->tmc", wl, ch)
          + torch.einsum("tpm,tpc->tmc", wh, cl)
          + torch.einsum("tpm,tpc->tmc", wh, ch))               # (T, M, C)
    tox, toy = _tile_origin(tile_ids, tiles_x)
    mx = recs[:, 0] - tox - 7.5
    my = recs[:, 1] - toy - 7.5
    M = [Mg[..., i] for i in range(6)]
    op = recs[:, 5]
    return dict(
        s_dx=M[3] - mx * M[5], s_dy=M[4] - my * M[5],
        s_dxx=M[0] - 2.0 * mx * M[3] + mx * mx * M[5],
        s_dxy=M[1] - my * M[3] - mx * M[4] + mx * my * M[5],
        s_dyy=M[2] - 2.0 * my * M[4] + my * my * M[5],
        s_ge=torch.where(op > 0, M[5] / torch.where(op > 0, op,
                                                    torch.ones_like(op)),
                         torch.zeros_like(op)),
        g_cols=Mw)


def blend_backward_plain(recs: torch.Tensor, counts: torch.Tensor,
                         out: torch.Tensor, g: torch.Tensor, tiles_x: int,
                         tile_ids=None, sums=None) -> torch.Tensor:
    """Plain K5: the walk's suffix-identity gradients -> (T, mpt, 16);
    `sums` replaces the direct per-record sums (the TF32 mirror's)."""
    T, _, M = recs.shape
    C = out.shape[-1]
    if tile_ids is None:
        tile_ids = torch.arange(T, device=recs.device)
    s = sums or _backward_sums(recs, counts, out, g, tiles_x, tile_ids)
    ca, cb, cc = recs[:, 2], recs[:, 3], recs[:, 4]
    rows = torch.stack([ca * s["s_dx"] + cb * s["s_dy"],
                        cc * s["s_dy"] + cb * s["s_dx"], -0.5 * s["s_dxx"],
                        -s["s_dxy"], -0.5 * s["s_dyy"], s["s_ge"]], -1)
    return torch.cat([rows, s["g_cols"], rows.new_zeros((T, M, RECW - 6 - C))],
                     -1).contiguous()


def blend_backward(recs: torch.Tensor, counts: torch.Tensor, out: torch.Tensor,
                   g: torch.Tensor, tiles_x: int,
                   tile_ids: torch.Tensor | None = None,
                   tile_offset: int = 0) -> torch.Tensor:
    """K5: replay the walk -> (T, mpt, 16) per-record gradient rows; a row of
    count 0 gives zeros whatever its cotangent."""
    T, _, M = recs.shape
    if recs.device.type == "cpu":
        return blend_backward_plain(recs, counts, out, g, tiles_x, image_tiles(
            T, tile_ids, tile_offset, recs.device))
    g = g.contiguous()
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
    tids = check_tile_ids(tile_ids, T, recs.device)
    grad = torch.empty((T, M, RECW), dtype=torch.float32, device=recs.device)
    lib = _build.library("blend")
    err = lib.vtgs_blend_bwd(recs.data_ptr(), counts.data_ptr(), tids,
                             out.data_ptr(), g.data_ptr(), T, M, tiles_x,
                             int(tile_offset), C, grad.data_ptr(),
                             _build.stream_of(recs))
    _build.check(lib, err, "vtgs_blend_bwd launch")
    _build.count_launch(blend_backward)
    return grad


blend_backward.launches = 0
