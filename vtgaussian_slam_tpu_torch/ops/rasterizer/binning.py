"""Tile binning shared by every render path.

Parity: `vtgaussian_slam_tpu/ops/rasterizer/binning.py`. Every Gaussian owns
span_cap^2 (tile, gaussian) pair slots; ONE stable sort of the fused int32
key `tile << depth_bits | rank` (pair id s*N + g breaks ties) orders them,
and per-tile windows of the sorted order form the (n_tiles, mpt) gather
table. Tables, counts and inverse maps match the JAX package bit for bit
on the same projected inputs.

`with_inverse=True` also records, for every (gaussian, slot) pair, the flat
table position it landed in (or -1): the transpose of the table gather is
then a gather (`apply_slot_inverse`; `table_gather`'s backward) instead
of a scatter-add.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .projection import ProjectedGaussians


class BinnedPairs(NamedTuple):
    tab: torch.Tensor            # (n_tiles, mpt) int64 gaussian per slot
    counts: torch.Tensor         # (n_tiles,) int32 valid slots per tile
    inv_pos: torch.Tensor | None  # (N, s2) int32 table position or -1


# the row multiple tile-sharded caches pad to: the JAX splat kernels' tile
# block, kept so that tables and padding compare with the JAX package's bit
# for bit (the port's kernels take any row count)
BLOCK = 8


class SlotInv(NamedTuple):
    """Sorted dense inverse map: s2 index columns, valid first."""
    pos: torch.Tensor   # (N, s2) int64 flat positions, clipped to >= 0
    w: torch.Tensor     # (N, s2) f32 1.0 / 0.0 (0 = pad)


def tile_rects(proj: ProjectedGaussians, tile: int, span_cap: int,
               tiles_x: int, tiles_y: int):
    """Tile rectangle per Gaussian (CUDA getRect semantics with a span cap;
    oversized rects re-centre on the mean's tile).
    Returns (rx0, ry0, span_x, span_y, valid)."""
    px, py = proj.mean2d[:, 0], proj.mean2d[:, 1]
    r = proj.radius
    i32 = torch.int32
    rx0 = torch.clamp(torch.floor((px - r) / tile), 0, tiles_x).to(i32)
    ry0 = torch.clamp(torch.floor((py - r) / tile), 0, tiles_y).to(i32)
    rx1 = torch.clamp(torch.floor((px + r) / tile) + 1, 0, tiles_x).to(i32)
    ry1 = torch.clamp(torch.floor((py + r) / tile) + 1, 0, tiles_y).to(i32)
    ctx = torch.clamp(torch.floor(px / tile), 0, tiles_x - 1).to(i32)
    cty = torch.clamp(torch.floor(py / tile), 0, tiles_y - 1).to(i32)

    def recentre(r0, r1, c):
        lo = torch.minimum(torch.maximum(c - span_cap // 2, r0), r1 - span_cap)
        return torch.where(r1 - r0 > span_cap, lo, r0)

    rx0 = recentre(rx0, rx1, ctx)
    ry0 = recentre(ry0, ry1, cty)
    span_x = torch.clamp(rx1 - rx0, max=span_cap)
    span_y = torch.clamp(ry1 - ry0, max=span_cap)
    valid = proj.valid & (span_x > 0) & (span_y > 0)
    return rx0, ry0, span_x, span_y, valid


def _pair_sort(proj: ProjectedGaussians, tile: int, span_cap: int,
               tiles_x: int, tiles_y: int, select: str) -> dict:
    """Emit every (tile, gaussian) pair slot, rank it with one stable
    fused-key sort, and locate the per-tile windows."""
    N = proj.mean2d.shape[0]
    dev = proj.mean2d.device
    n_tiles = tiles_x * tiles_y
    s2 = span_cap * span_cap
    p_max = N * s2
    depth_bits = min(31 - max(int(n_tiles).bit_length(), 1), 21)
    qmax = (1 << depth_bits) - 1

    rx0, ry0, span_x, span_y, valid = tile_rects(
        proj, tile, span_cap, tiles_x, tiles_y)
    sentinel = n_tiles << depth_bits
    # log-depth quantization over a fixed [1e-3, 1e4] m range
    d = proj.depth
    log_lo, log_span = -6.90776, 16.1181
    dl = torch.log(torch.clamp(
        torch.where(torch.isfinite(d), d, torch.full_like(d, 1e4)),
        1e-3, 1e4))
    qd = torch.clamp((dl - log_lo) * (qmax / log_span), 0, qmax).to(torch.int32)
    px, py = proj.mean2d[:, 0], proj.mean2d[:, 1]
    r2 = (1.11 * proj.radius) ** 2
    if select == "importance":
        ca, cb, cc = proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2]
        nlop = -torch.log(torch.clamp(proj.opacity, min=1e-6))
        imp_scale = qmax / 14.0
    elif select != "depth":
        raise ValueError(f"unknown select mode {select!r}")
    slot_keys = []
    for s in range(s2):
        dy, dx = s // span_cap, s % span_cap
        ok = valid & (dy < span_y) & (dx < span_x)
        tx0 = (rx0 + dx).to(px.dtype) * tile
        ty0 = (ry0 + dy).to(py.dtype) * tile
        dxp = px - torch.minimum(torch.maximum(px, tx0), tx0 + (tile - 1))
        dyp = py - torch.minimum(torch.maximum(py, ty0), ty0 + (tile - 1))
        ok = ok & (dxp * dxp + dyp * dyp <= r2)
        if select == "importance":
            power = (0.5 * (ca * dxp * dxp + cc * dyp * dyp)
                     + cb * dxp * dyp)
            qr = torch.clamp((nlop + torch.clamp(power, min=0.0)) * imp_scale,
                             0, qmax).to(torch.int32)
        else:
            qr = qd
        key = (((ry0 + dy) * tiles_x + rx0 + dx) << depth_bits) | qr
        slot_keys.append(torch.where(
            ok, key, torch.full_like(key, sentinel)))
    pair_key = torch.stack(slot_keys).reshape(-1)               # (p_max,)
    s_key, s_id = torch.sort(pair_key, stable=True)            # id = s*N + g
    tid = torch.arange(n_tiles + 1, dtype=torch.int32, device=dev) << depth_bits
    edges = torch.searchsorted(s_key, tid, side="left")
    return dict(N=N, s2=s2, p_max=p_max, depth_bits=depth_bits,
                sentinel=sentinel, qd=qd, s_key=s_key, s_id=s_id,
                start=edges[:-1], end=edges[1:])


def _windows(ps: dict, mpt: int, select: str):
    """The per-tile windows of the sorted pairs at the budget mpt: (tab,
    counts, pid), pid the sorted pair ids of the window in blend order.
    select="importance" keeps a saturated tile's top-alpha pairs (the
    sort's rank) and restores exact (depth, pair id) blend order within
    the kept window; "depth" keeps the depth prefix."""
    N, p_max = ps["N"], ps["p_max"]
    start, end = ps["start"], ps["end"]
    counts = torch.clamp(end - start, max=mpt)
    j = torch.arange(mpt, device=start.device)
    window = torch.clamp(start[:, None] + j[None, :], max=p_max - 1)
    pid = ps["s_id"][window]                                   # (T, mpt)
    if select == "importance":
        in_count = j[None, :] < counts[:, None]
        qd_w = torch.where(in_count, ps["qd"][pid % N].long(),
                           torch.full_like(pid, 2 ** 30))
        # lexicographic (depth, pair id) as one int64 key
        key = (qd_w << 32) | pid
        pid = torch.gather(pid, 1, torch.argsort(key, dim=1, stable=True))
    return pid % N, counts.to(torch.int32), pid


def _scatter_kept(buf: torch.Tensor, pid: torch.Tensor, counts: torch.Tensor
                  ) -> None:
    """buf[pair id] = flat table position (row * mpt + j) for the in-count
    slots of a window table (the importance inverse)."""
    rows, mpt = pid.shape
    in_count = (torch.arange(mpt, device=pid.device)[None, :]
                < counts[:, None])
    flat = torch.arange(rows * mpt, device=pid.device).reshape(rows, mpt)
    buf[pid[in_count]] = flat[in_count].to(torch.int32)


@torch.no_grad()
def bin_gaussians(proj: ProjectedGaussians, tile: int, span_cap: int,
                  tiles_x: int, tiles_y: int, mpt: int,
                  with_inverse: bool = False,
                  select: str = "depth") -> BinnedPairs:
    """Bin projected Gaussians into per-tile depth-ordered gather tables.

    select="importance" keeps a saturated tile's top-alpha pairs (ranked by
    max alpha over the tile) and then restores exact (depth, pair id) blend
    order within the kept window; select="depth" keeps the depth prefix."""
    ps = _pair_sort(proj, tile, span_cap, tiles_x, tiles_y, select)
    N, p_max, s2 = ps["N"], ps["p_max"], ps["s2"]
    n_tiles = tiles_x * tiles_y
    dev = proj.mean2d.device
    tab, counts, pid = _windows(ps, mpt, select)
    inv_pos = None
    if with_inverse:
        buf = torch.full((p_max,), -1, dtype=torch.int32, device=dev)
        if select == "importance":
            _scatter_kept(buf, pid, counts)
        else:
            s_key, start = ps["s_key"], ps["start"]
            rank = torch.arange(p_max, device=dev)
            in_image = s_key < ps["sentinel"]
            tile_safe = torch.clamp(s_key >> ps["depth_bits"],
                                    max=n_tiles - 1).long()
            off = rank - start[tile_safe]
            pos = torch.where(in_image & (off < mpt), tile_safe * mpt + off,
                              torch.full_like(off, -1))
            buf[ps["s_id"]] = pos.to(torch.int32)
        inv_pos = buf.reshape(s2, N).T.contiguous()
    return BinnedPairs(tab=tab, counts=counts, inv_pos=inv_pos)


class _TableGather(torch.autograd.Function):
    """`vals[tab]` whose backward is the dense inverse-map gather: each
    Gaussian sums the cotangent rows of its s2 slots, a -1 pad reading an
    appended zero row. No scatter-add, no atomics."""

    @staticmethod
    def forward(ctx, vals, tab, inv_pos):
        ctx.save_for_backward(inv_pos)
        return vals[tab]

    @staticmethod
    def backward(ctx, g):
        inv_pos, = ctx.saved_tensors
        C = g.shape[-1]
        flat = torch.cat([g.reshape(-1, C), g.new_zeros((1, C))])
        idx = torch.where(inv_pos >= 0, inv_pos, flat.shape[0] - 1).long()
        return flat[idx].sum(1), None, None


def table_gather(vals: torch.Tensor, tab: torch.Tensor,
                 inv_pos: torch.Tensor) -> torch.Tensor:
    """Differentiable per-slot gather `vals[tab]` ((N, C) values, an
    (n_tiles, mpt) table, the (N, s2) inverse map of `bin_gaussians(...,
    with_inverse=True)`). Slots past a tile's count hold clamped indices no
    inverse entry names: their cotangents must be zero (the renderers mask
    by count), and then the backward is the gather's exact transpose."""
    return _TableGather.apply(vals, tab, inv_pos)


def gather_channels(vals: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """(N, C) row-major values -> (T, C, mpt) contiguous slot planes."""
    return vals[tab].transpose(1, 2).contiguous()


def slot_inverse(inv_pos: torch.Tensor) -> SlotInv:
    """Sorted inverse map from a raw (N, s2) one: valid (>= 0) first."""
    srt = torch.sort(inv_pos, dim=1, descending=True).values
    return SlotInv(pos=torch.clamp(srt, min=0).long(),
                   w=(srt >= 0).to(torch.float32))


def weighted_inverse(flat: torch.Tensor, pos: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """sum_k flat[pos[:, k]] * w[:, k:k+1]: (P, C) cotangent rows, (N, s2)
    in-range positions and (N, s2) f32 weights (0 disables a column) ->
    (N, C); s2 plain row gathers combined in column order."""
    g = flat[pos[:, 0]] * w[:, 0:1]
    for k in range(1, pos.shape[1]):
        g = g + flat[pos[:, k]] * w[:, k:k + 1]
    return g


def apply_slot_inverse(flat: torch.Tensor, inv: SlotInv) -> torch.Tensor:
    """(P, C) flat cotangent rows -> (N, C) per-gaussian sums, the exact
    transpose of the slot gather."""
    return weighted_inverse(flat, inv.pos, inv.w)
