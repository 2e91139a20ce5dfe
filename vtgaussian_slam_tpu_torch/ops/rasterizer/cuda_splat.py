"""Fused splat kernels K1-K3 and K6: world-space slots + pose -> tile image.

Replaces `vtgaussian_slam_tpu/ops/rasterizer/pallas_splat.py`:

  K1 `splat_forward`            <- `_fwd_call` / `_fwd_kernel`
  K2 `splat_backward_pose`      <- `_bwd_call` / `_bwd_kernel`, mode "pose"
  K3 `splat_backward_vals_rows` <- `_bwd_call` / `_bwd_kernel`, mode "vals_rows"
  K6 `splat_backward_all`       <- `_bwd_call` / `_bwd_kernel`, mode "all"

`splat_blend(..., grad_mode)` is `splat_blend` of the JAX package as a
`torch.autograd.Function`: K1 forward and, by grad_mode, K2 ("pose": dR,
dt only), K3 ("vals" / "vals_rows": the value rows, transposed to the
slot layout; mode "vals" of the JAX kernel is the same sums as K3) or K6
("all": every slot row, with dR and dt contracted and d mean rotated to
world here, as the JAX wrapper `_splat_bwd` does). Tracking's cached
renderer uses "pose"; "all", the JAX default, has no engine caller.

The CUDA sources are `csrc/splat.cu` (its header says what bounds the
kernels on the H100 and what the simple design does about it). Each
wrapper launches its kernel for CUDA tensors, counts the launch in its
`launches` attribute, and runs the plain PyTorch version beside it only
for tensors on the CPU. The plain versions are vectorised over (tiles,
pixels, slots) with the kernels' masks and termination rule; the CPU tests
and `chip_smoke.py` hold the kernels against them. Beside them stand
mirrors of what only the kernels do, for the CPU tests alone: `slot_box`
(the per-slot cull box), `splat_forward_grouped` (K1's box cull and grouped
select blends) and `backward_sums_tf32` (the backwards' split products).

Every wrapper takes `tile_ids` (the image tile of each row, for rows that
hold a subset of the image's tiles; no engine route passes it) and
`tile_offset` (added to it: a tile-sharded rank's first tile), as the JAX
kernels' `tids` and `meta[1]`; the row still addresses every operand. A row of count 0 renders nothing and its
backward rows are zeros, whatever its cotangent.

Layouts: slots8 (T, 8, mpt) rows [wx wy wz logit_op log_scale r g b];
accum (T, 8, 256) channels (r, g, b, z, 1, z^2, T_end, 0). Channel 6 is
the final transmittance (0 where the walk terminated) and carries no
gradient. The JAX kernels pad T to a multiple of 8 tiles; the port does
not, and compares only the real tiles.
"""
from __future__ import annotations

import torch

from ..camera import Camera
from . import _build
from .blend import ALPHA_MAX, ALPHA_MIN, T_TERMINATE
from .projection import COV2D_DILATION, NEAR_CULL

TILE = 16
TPX = TILE * TILE
NWARP = TPX // 32
NCH = 8
POWER_MAX = 1e-3   # the splat kernels keep power <= 1e-3 (K4 keeps <= 0)


_CAM_CONSTS: dict = {}   # (camera, device) -> its 6 constants on the device


def cp_vector(R9: torch.Tensor, trans: torch.Tensor, cam: Camera) -> torch.Tensor:
    """(18,) f32 [R(9) t(3) fx fy cx cy 1.3 tanfovx 1.3 tanfovy], on the
    pose's device. The camera's constants are uploaded once per camera and
    device: a host-to-device copy from pageable memory waits for the
    stream, and the wrappers build this vector on every launch."""
    key = (cam, R9.device)
    consts = _CAM_CONSTS.get(key)
    if consts is None:
        consts = _CAM_CONSTS[key] = torch.tensor(
            [cam.fx, cam.fy, cam.cx, cam.cy, 1.3 * cam.tanfovx,
             1.3 * cam.tanfovy], dtype=torch.float32, device=R9.device)
    return torch.cat([R9.reshape(9).float(), trans.reshape(3).float(),
                      consts]).contiguous()


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------
def _project(slots8: torch.Tensor, cp: torch.Tensor) -> dict:
    """Per-slot projection (T, mpt) fields: the kernels' `project`."""
    wx, wy, wz = slots8[:, 0], slots8[:, 1], slots8[:, 2]
    lo, ls = slots8[:, 3], slots8[:, 4]
    R, t = cp[:9], cp[9:12]
    fx, fy, cx, cy, limx, limy = (float(v) for v in cp[12:18])
    x = R[0] * wx + R[1] * wy + R[2] * wz + t[0]
    y = R[3] * wx + R[4] * wy + R[5] * wz + t[1]
    z = R[6] * wx + R[7] * wy + R[8] * wz + t[2]
    ok = z > NEAR_CULL
    zs = torch.where(ok, z, torch.ones_like(z))
    iz = 1.0 / zs
    ux, uy = x * iz, y * iz
    cux = torch.clamp(ux, -limx, limx)
    cuy = torch.clamp(uy, -limy, limy)
    tx, ty = cux * zs, cuy * zs
    iz2 = iz * iz
    j00 = fx * iz
    j02 = -fx * tx * iz2
    j11 = fy * iz
    j12 = -fy * ty * iz2
    s = torch.exp(ls)
    s2 = s * s
    ax = j00 * j00 + j02 * j02
    bxy = j02 * j12
    cy_ = j11 * j11 + j12 * j12
    v00 = s2 * ax + COV2D_DILATION
    v01 = s2 * bxy
    v11 = s2 * cy_ + COV2D_DILATION
    det = v00 * v11 - v01 * v01
    ok = ok & (det > 0)
    idet = 1.0 / torch.where(det > 0, det, torch.ones_like(det))
    sig = torch.sigmoid(lo)
    return dict(
        wx=wx, wy=wy, wz=wz, x=x, y=y, z=z, ok=ok, zs=zs, iz=iz, ux=ux,
        uy=uy, cux=cux, cuy=cuy, j00=j00, j02=j02, j11=j11, j12=j12, s2=s2,
        ax=ax, bxy=bxy, cy_=cy_, ca=v11 * idet, cb=-v01 * idet,
        cc=v00 * idet,
        m2x=torch.where(ok, fx * ux + cx - 0.5, torch.full_like(ux, -1e6)),
        m2y=fy * uy + cy - 0.5, sig=sig,
        op=torch.where(ok, sig, torch.zeros_like(sig)),
        fx=fx, fy=fy, limx=limx, limy=limy)


def _walk(slots8, counts, cp, tiles_x, tile_ids):
    """Every (tile, pixel, slot) quantity of the front-to-back walk."""
    T, _, M = slots8.shape
    dev = slots8.device
    q = _project(slots8, cp)
    if tile_ids is None:
        tile_ids = torch.arange(T, device=dev)
    tox = ((tile_ids % tiles_x) * TILE).float()[:, None]
    toy = ((tile_ids // tiles_x) * TILE).float()[:, None]
    lin = torch.arange(TPX, device=dev)
    lx = (lin % TILE).float()[None, :, None]
    ly = (lin // TILE).float()[None, :, None]
    dx = lx - (q["m2x"] - tox)[:, None, :]                    # (T, P, M)
    dy = ly - (q["m2y"] - toy)[:, None, :]
    ca, cb, cc = (q[k][:, None, :] for k in ("ca", "cb", "cc"))
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    expp = torch.exp(power)
    araw = q["op"][:, None, :] * expp
    clamped = araw > ALPHA_MAX
    alpha = torch.clamp(araw, max=ALPHA_MAX)
    in_count = (torch.arange(M, device=dev)[None, :]
                < counts.to(dev)[:, None])[:, None, :]
    keep = (power <= POWER_MAX) & (alpha >= ALPHA_MIN) & in_count
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    T_after = torch.cumprod(1.0 - alpha, dim=-1)
    T_in = torch.cat([torch.ones_like(T_after[..., :1]), T_after[..., :-1]], -1)
    include = T_after >= T_TERMINATE
    weight = torch.where(include, alpha * T_in, torch.zeros_like(alpha))
    cols = torch.stack([slots8[:, 5], slots8[:, 6], slots8[:, 7], q["z"],
                        torch.ones_like(q["z"]), q["z"] * q["z"]], 1)
    # walked: pairs the kernels evaluate (slot live, pixel still open)
    return dict(q=q, dx=dx, dy=dy, power=power, expp=expp, alpha=alpha,
                clamped=clamped,
                keep=keep, T_in=T_in, T_after=T_after, include=include,
                weight=weight, cols=cols,
                walked=in_count & (T_in >= T_TERMINATE))


def splat_forward_plain(slots8, counts, cp, tiles_x, tile_ids=None):
    """Plain K1: (T, 8, mpt) slots -> (T, 8, 256) accum."""
    w = _walk(slots8, counts, cp, tiles_x, tile_ids)
    acc = torch.einsum("tpm,tcm->tcp", w["weight"], w["cols"])
    T_last = w["T_after"][..., -1]
    T_end = torch.where(T_last < T_TERMINATE, torch.zeros_like(T_last), T_last)
    return torch.cat([acc, T_end[:, None], torch.zeros_like(T_end)[:, None]], 1)



def box_radius2(op: torch.Tensor) -> torch.Tensor:
    """The kernels' `box_radius2`: a pair is kept only where alpha =
    op exp(-Q/2) >= 1/255, i.e. where Q <= 2 ln(255 op); padded by 0.1% and
    1e-4, far above the rounding of the walks' own alpha test."""
    return 2.0 * torch.log(255.0 * op) * 1.001 + 1e-4


EMPTY_BOX = (1e30, -1e30, 1e30, -1e30)
WHOLE_BOX = (-1e30, 1e30, -1e30, 1e30)


def cull_boxes(mx, my, hx, hy, has_box, whole=None):
    """(..., 4) boxes [xlo, xhi, ylo, yhi]: empty where not `has_box`, the
    whole plane where `whole`."""
    box = torch.stack([mx - hx, mx + hx, my - hy, my + hy], -1)
    if whole is not None:
        box = torch.where(whole[..., None], box.new_tensor(WHOLE_BOX), box)
    return torch.where(has_box[..., None], box, box.new_tensor(EMPTY_BOX))


def slot_box(slots8, cp, tiles_x, tile_ids=None, q=None):
    """The splat kernels' per-slot cull box (`stage_slot` of csrc/splat.cu),
    (T, mpt, 4) [xlo, xhi, ylo, yhi] in tile-local pixel coordinates: the
    extent of the ellipse Q <= box_radius2(op), sqrt(r2 v00) by sqrt(r2 v11)
    for the 2D covariance v, about the slot mean; empty (lo > hi) for
    op < 1/255, which covers every culled slot (op 0)."""
    q = q or _project(slots8, cp)
    T = slots8.shape[0]
    if tile_ids is None:
        tile_ids = torch.arange(T, device=slots8.device)
    mx = q["m2x"] - ((tile_ids % tiles_x) * TILE).float()[:, None]
    my = q["m2y"] - ((tile_ids // tiles_x) * TILE).float()[:, None]
    has_box = q["op"] >= ALPHA_MIN
    r2 = box_radius2(torch.where(has_box, q["op"], torch.ones_like(q["op"])))
    hx = torch.sqrt(r2 * (q["s2"] * q["ax"] + COV2D_DILATION))
    hy = torch.sqrt(r2 * (q["s2"] * q["cy_"] + COV2D_DILATION))
    return cull_boxes(mx, my, hx, hy, has_box)


def block_pixels(x: torch.Tensor) -> torch.Tensor:
    """(T, 256, ...) per-pixel values -> (T, 8, 32, ...) by the kernels'
    warps: warp w owns the 8 x 4 pixel block at (8 (w & 1), 4 (w >> 1))."""
    T, rest = x.shape[0], x.shape[2:]
    x = x.reshape(T, 4, 4, 2, 8, *rest)            # (by, y, bx, x)
    return x.transpose(2, 3).reshape(T, NWARP, 32, *rest)


def unblock_pixels(x: torch.Tensor) -> torch.Tensor:
    """The inverse of `block_pixels`: (T, 8, 32, ...) -> (T, 256, ...)."""
    T, rest = x.shape[0], x.shape[3:]
    x = x.reshape(T, 4, 2, 4, 8, *rest)            # (by, bx, y, x)
    return x.transpose(2, 3).reshape(T, TPX, *rest)


def box_meets_blocks(box: torch.Tensor) -> torch.Tensor:
    """(T, M, 4) tile-local boxes -> (T, 8, M): can a pixel of warp w's 8 x 4
    block lie in the box (the kernels' `WarpBlock::meets`)?"""
    w = torch.arange(NWARP, device=box.device)
    x0 = (8 * (w & 1)).float()[None, :, None]
    y0 = (4 * (w >> 1)).float()[None, :, None]
    b = box[:, None]                                # (T, 1, M, 4)
    return ((b[..., 0] <= x0 + 7.0) & (b[..., 1] >= x0)
            & (b[..., 2] <= y0 + 3.0) & (b[..., 3] >= y0))


def splat_forward_grouped(slots8, counts, cp, tiles_x, tile_ids=None, ng=4):
    """K1's walk in plain PyTorch (the tests use it; no engine path does):
    a warp's pixels evaluate only the slots whose box meets their 8 x 4
    block, `ng` slots at a time (alpha does not depend on the walk's
    state), and blend them front to back with selects; a pixel stops at
    the first slot whose transmittance after blending would fall below
    1e-4. Returns (T, 8, 256) like `splat_forward_plain`."""
    T, _, M = slots8.shape
    dev = slots8.device
    w = _walk(slots8, counts, cp, tiles_x, tile_ids)
    q = w["q"]
    meets = box_meets_blocks(slot_box(slots8, cp, tiles_x, tile_ids, q))
    lin = torch.arange(TPX, device=dev)
    live = meets[:, (lin // TILE // 4) * 2 + lin % TILE // 8]   # (T, P, M)
    alpha = torch.clamp(q["op"][:, None, :] * w["expp"], max=ALPHA_MAX)
    in_count = (torch.arange(M, device=dev)[None, :]
                < counts.to(dev)[:, None])[:, None, :]
    kp = live & in_count & (w["power"] <= POWER_MAX) & (alpha >= ALPHA_MIN)
    cols = w["cols"]                                            # (T, 6, M)
    Tr = torch.ones((T, TPX), device=dev)
    done = torch.zeros((T, TPX), dtype=torch.bool, device=dev)
    acc = torch.zeros((T, 6, TPX), device=dev)
    zero = torch.zeros((), device=dev)
    for k0 in range(0, M, ng):
        al_g, kp_g = alpha[..., k0:k0 + ng], kp[..., k0:k0 + ng]
        for j in range(al_g.shape[-1]):
            al = al_g[..., j]
            keep = kp_g[..., j] & ~done
            Ta = Tr * (1.0 - al)
            stop = keep & (Ta < T_TERMINATE)
            blend = keep & ~stop
            done = done | stop
            wgt = torch.where(blend, al * Tr, zero)
            acc = acc + wgt[:, None, :] * cols[:, :, k0 + j, None]
            Tr = torch.where(blend, Ta, Tr)
    T_end = torch.where(done, zero, Tr)
    return torch.cat([acc, T_end[:, None], torch.zeros_like(T_end)[:, None]], 1)


def _backward_pairs(slots8, counts, cp, tiles_x, out, g, tile_ids):
    """Replay the walk: (walk, d alpha, d power = d alpha * alpha) per
    (tile, pixel, slot), zero where the pair was not blended."""
    w = _walk(slots8, counts, cp, tiles_x, tile_ids)
    GG = (g * out).sum(1)                                       # (T, P)
    Gc = torch.einsum("tcp,tcm->tpm", g[:, :6], w["cols"])
    wGc = w["weight"] * Gc
    Hk = torch.cumsum(wGc, dim=-1)
    inv_om = 1.0 / torch.clamp(1.0 - w["alpha"], min=1e-6)
    ga = torch.where(w["include"] & w["keep"] & ~w["clamped"],
                     w["T_in"] * Gc - (GG[..., None] - Hk) * inv_om,
                     torch.zeros_like(Gc))
    return w, ga, ga * w["alpha"]


def _backward_sums(slots8, counts, cp, tiles_x, out, g, tile_ids):
    """Replay the walk and reduce the per-slot pixel sums of both modes."""
    w, ga, gp = _backward_pairs(slots8, counts, cp, tiles_x, out, g, tile_ids)
    dx, dy = w["dx"], w["dy"]
    z = w["q"]["z"]
    sums = dict(
        s_dx=(gp * dx).sum(1), s_dy=(gp * dy).sum(1),
        s_dxx=(gp * dx * dx).sum(1), s_dxy=(gp * dx * dy).sum(1),
        s_dyy=(gp * dy * dy).sum(1), s_ge=(ga * w["expp"]).sum(1),
        g_rgb=torch.einsum("tpm,tcp->tcm", w["weight"], g[:, 0:3]),
        g_zc=(w["weight"] * (g[:, 3][..., None]
                             + 2.0 * z[:, None, :] * g[:, 5][..., None])).sum(1))
    return w["q"], sums


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest value with 10 mantissa bits, ties away from zero
    (`cvt.rna.tf32.f32`), as an f32 tensor."""
    b = x.float().contiguous().view(torch.int32)
    mag = ((b & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (mag | (b & ~0x7FFFFFFF)).view(torch.float32)


def _split_tf32(x):
    """x = hi + lo as the kernels split it: hi rounded to TF32, lo = x - hi
    (exact in f32), of which the mma reads the top 19 bits (truncated)."""
    hi = tf32_round(x)
    lo = (x - hi).contiguous().view(torch.int32) & ~0x1FFF
    return hi, lo.view(torch.float32)


def pixel_moment_basis(device=None) -> torch.Tensor:
    """(256, 6) PHI = [cx^2, cx cy, cy^2, cx, cy, 1] with cx, cy the pixel's
    coordinates about the tile centre (lx - 7.5, ly - 7.5)."""
    lin = torch.arange(TPX, device=device)
    cx = (lin % TILE).float() - 7.5
    cy = (lin // TILE).float() - 7.5
    return torch.stack([cx * cx, cx * cy, cy * cy, cx, cy,
                        torch.ones_like(cx)], 1)


def backward_sums_tf32(slots8, counts, cp, tiles_x, out, g, tile_ids=None):
    """The backward kernels' reduction in plain PyTorch (the tests use it;
    no engine path does): the per-slot sums of `_backward_sums` as the
    tensor-core products Mg = GP . PHI and Mw = W . GC, on operands
    rounded to TF32 and split a = hi + lo (GP . PHI as hi + lo, PHI being
    exact; W . GC as hi.hi + hi.lo + lo.hi), then the epilogue that
    rebuilds the dx / dy sums from the moments about the tile centre."""
    w, _, gp = _backward_pairs(slots8, counts, cp, tiles_x, out, g, tile_ids)
    phi = pixel_moment_basis(slots8.device)
    gc = torch.stack([g[:, 0], g[:, 1], g[:, 2], g[:, 3], g[:, 5]], -1)
    gh, gl = _split_tf32(gp)
    Mg = (torch.einsum("tpm,pc->tmc", gl, phi)
          + torch.einsum("tpm,pc->tmc", gh, phi))               # (T, M, 6)
    wh, wl = _split_tf32(w["weight"])
    ch, cl = _split_tf32(gc)
    Mw = (torch.einsum("tpm,tpc->tmc", wl, ch)
          + torch.einsum("tpm,tpc->tmc", wh, cl)
          + torch.einsum("tpm,tpc->tmc", wh, ch))               # (T, M, 5)
    q = w["q"]
    T = slots8.shape[0]
    if tile_ids is None:
        tile_ids = torch.arange(T, device=slots8.device)
    tox = ((tile_ids % tiles_x) * TILE).float()[:, None]
    toy = ((tile_ids // tiles_x) * TILE).float()[:, None]
    mx = q["m2x"] - tox - 7.5
    my = q["m2y"] - toy - 7.5
    M = [Mg[..., i] for i in range(6)]
    op = q["op"]
    s_ge = torch.where(op > 0, M[5] / torch.where(op > 0, op,
                                                  torch.ones_like(op)),
                       torch.zeros_like(op))
    sums = dict(
        s_dx=M[3] - mx * M[5], s_dy=M[4] - my * M[5],
        s_dxx=M[0] - 2.0 * mx * M[3] + mx * mx * M[5],
        s_dxy=M[1] - my * M[3] - mx * M[4] + mx * my * M[5],
        s_dyy=M[2] - 2.0 * my * M[4] + my * my * M[5], s_ge=s_ge,
        g_rgb=Mw[..., 0:3].transpose(1, 2),
        g_zc=Mw[..., 3] + 2.0 * q["z"] * Mw[..., 4])
    return q, sums


def moment_sums_error(slots8, counts, cp, tiles_x, out, g, tile_ids=None):
    """Largest error of `backward_sums_tf32` against `_backward_sums`, per
    sum and over all, each scaled by that sum's largest |value|."""
    _, ref = _backward_sums(slots8, counts, cp, tiles_x, out, g, tile_ids)
    _, got = backward_sums_tf32(slots8, counts, cp, tiles_x, out, g, tile_ids)
    errs = {}
    for k, r in ref.items():
        scale = max(float(r.abs().max()), 1e-30)
        errs[k] = float((got[k] - r).abs().max()) / scale
    errs["max"] = max(errs.values())
    return errs


def _conic_chain(q, sums):
    """dL/d conic -> dL/d 2D covariance (symmetric packing)."""
    ca, cb, cc = q["ca"], q["cb"], q["cc"]
    a0, a1, a2 = -0.5 * sums["s_dxx"], -0.5 * sums["s_dxy"], -0.5 * sums["s_dyy"]
    ca0 = ca * a0 + cb * a1
    ca1 = ca * a1 + cb * a2
    cb0 = cb * a0 + cc * a1
    cb1 = cb * a1 + cc * a2
    return (-(ca0 * ca + ca1 * cb), -2.0 * (ca0 * cb + ca1 * cc),
            -(cb0 * cb + cb1 * cc))


def splat_backward_vals_rows_plain(slots8, counts, cp, tiles_x, out, g,
                                   tile_ids=None, sums=None):
    """Plain K3: -> (T, mpt, 8) rows [0 0 0 d lo, d ls, d r, d g, d b]."""
    q, s = sums or _backward_sums(slots8, counts, cp, tiles_x, out, g,
                                  tile_ids)
    okf = q["ok"].float()
    g_v00, g_v01, g_v11 = _conic_chain(q, s)
    g_lo = s["s_ge"] * q["sig"] * (1.0 - q["sig"]) * okf
    g_ls = 2.0 * q["s2"] * (g_v00 * q["ax"] + g_v01 * q["bxy"]
                            + g_v11 * q["cy_"]) * okf
    zeros = torch.zeros_like(g_lo)
    rows = torch.stack([zeros, zeros, zeros, g_lo, g_ls, s["g_rgb"][:, 0],
                        s["g_rgb"][:, 1], s["g_rgb"][:, 2]], -1)
    return rows.contiguous()


def _mean_cam_grad(q, s):
    """The per-slot chain power -> conic -> 2D cov -> Jacobian and mean2d
    -> d mean_cam, (T, 3, M)."""
    okf = q["ok"].float()
    g_v00, g_v01, g_v11 = _conic_chain(q, s)
    ca, cb, cc = q["ca"], q["cb"], q["cc"]
    fx, fy = q["fx"], q["fy"]
    g_m2x = (ca * s["s_dx"] + cb * s["s_dy"]) * okf
    g_m2y = cc * s["s_dy"] + cb * s["s_dx"]
    s2 = q["s2"]
    j00, j02, j11, j12 = q["j00"], q["j02"], q["j11"], q["j12"]
    g_j00 = 2.0 * s2 * j00 * g_v00
    g_j02 = s2 * (2.0 * j02 * g_v00 + j12 * g_v01)
    g_j11 = 2.0 * s2 * j11 * g_v11
    g_j12 = s2 * (2.0 * j12 * g_v11 + j02 * g_v01)
    iz, zs = q["iz"], q["zs"]
    iz2 = iz * iz
    tx, ty = q["cux"] * zs, q["cuy"] * zs
    g_iz = (fx * g_j00 + fy * g_j11 - 2.0 * fx * tx * iz * g_j02
            - 2.0 * fy * ty * iz * g_j12)
    g_tx = -fx * iz2 * g_j02
    g_ty = -fy * iz2 * g_j12
    in_x = (q["ux"].abs() <= q["limx"]).float()
    in_y = (q["uy"].abs() <= q["limy"]).float()
    g_x = (g_tx * in_x + g_m2x * fx * iz) * okf
    g_y = (g_ty * in_y + g_m2y * fy * iz) * okf
    g_zs = (g_tx * (q["cux"] - in_x * q["ux"]) + g_ty * (q["cuy"] - in_y * q["uy"])
            - iz2 * (g_iz + g_m2x * fx * q["x"] + g_m2y * fy * q["y"]))
    g_z = (g_zs + s["g_zc"]) * okf
    return torch.stack([g_x, g_y, g_z], 1)


def splat_backward_pose_plain(slots8, counts, cp, tiles_x, out, g,
                              tile_ids=None, sums=None):
    """Plain K2: -> (T, 12) per-tile partial [dR(9), dt(3)]."""
    q, s = sums or _backward_sums(slots8, counts, cp, tiles_x, out, g,
                                  tile_ids)
    g_cam = _mean_cam_grad(q, s)                                  # (T, 3, M)
    mw = torch.stack([q["wx"], q["wy"], q["wz"]], 1)
    dR = torch.einsum("tim,tjm->tij", g_cam, mw).reshape(-1, 9)
    return torch.cat([dR, g_cam.sum(-1)], 1)


def splat_backward_all_plain(slots8, counts, cp, tiles_x, out, g,
                             tile_ids=None, sums=None):
    """Plain K6: -> (T, 8, mpt) rows [d mean_cam(3), d lo, d ls, d rgb]."""
    q, s = sums or _backward_sums(slots8, counts, cp, tiles_x, out, g,
                                  tile_ids)
    rows = splat_backward_vals_rows_plain(slots8, counts, cp, tiles_x, out, g,
                                          tile_ids, (q, s))
    return torch.cat([_mean_cam_grad(q, s), rows.transpose(1, 2)[:, 3:]],
                     1).contiguous()


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def image_tiles(T: int, tile_ids, tile_offset: int, device):
    """The image tile of each of T operand rows, as the kernels' `image_tile`
    reads it: `tile_ids` (a per-row tile subset; None: the rows
    themselves) plus `tile_offset` (a tile-sharded rank's first tile). None
    when both are absent, so the plain versions take their own default."""
    if tile_ids is None and tile_offset == 0:
        return None
    ids = (torch.arange(T, device=device) if tile_ids is None
           else tile_ids.to(device))
    return ids + int(tile_offset)


def check_tile_ids(tile_ids, T: int, dev) -> int | None:
    """The kernels' tile-id operand: a pointer to (T,) contiguous int32 on
    the operands' device, or None (NULL: the rows themselves)."""
    if tile_ids is None:
        return None
    _build.require(tile_ids.dtype == torch.int32 and tile_ids.shape == (T,)
                   and tile_ids.is_contiguous() and tile_ids.device == dev,
                   "tile_ids must be contiguous int32 (T,) on the operands' "
                   "device")
    return tile_ids.data_ptr()


def _check_inputs(slots8, counts, cp, *extra):
    dev = slots8.device
    _build.require(slots8.dtype == torch.float32 and slots8.dim() == 3
                   and slots8.shape[1] == 8 and slots8.is_contiguous(),
                   f"slots8 must be contiguous f32 (T, 8, mpt), got "
                   f"{tuple(slots8.shape)} {slots8.dtype}")
    T = slots8.shape[0]
    _build.require(T >= 1, "no tiles")
    _build.require(counts.dtype == torch.int32 and counts.shape == (T,)
                   and counts.is_contiguous() and counts.device == dev,
                   "counts must be contiguous int32 (T,) on the slots' device")
    _build.require(cp.dtype == torch.float32 and cp.shape == (18,)
                   and cp.device == dev, "camera vector must be f32 (18,)")
    for t in extra:
        _build.require(t.dtype == torch.float32 and t.shape == (T, NCH, TPX)
                       and t.is_contiguous() and t.device == dev,
                       "accum / cotangent must be contiguous f32 (T, 8, 256)")


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def splat_forward(slots8: torch.Tensor, R9: torch.Tensor, trans: torch.Tensor,
                  counts: torch.Tensor, cam: Camera, tiles_x: int,
                  tile_ids: torch.Tensor | None = None,
                  tile_offset: int = 0) -> torch.Tensor:
    """K1: slots8 (T, 8, mpt) + pose -> accum (T, 8, 256). Row r renders the
    image tile `tile_ids[r]` (default r) + `tile_offset`."""
    cp = cp_vector(R9, trans, cam)
    T, _, M = slots8.shape
    if slots8.device.type == "cpu":
        return splat_forward_plain(slots8, counts, cp, tiles_x, image_tiles(
            T, tile_ids, tile_offset, slots8.device))
    _check_inputs(slots8, counts, cp)
    tids = check_tile_ids(tile_ids, T, slots8.device)
    out = torch.empty((T, NCH, TPX), dtype=torch.float32, device=slots8.device)
    lib = _build.library("splat")
    err = lib.vtgs_splat_fwd(_ptr(slots8), _ptr(counts), tids, _ptr(cp), T, M,
                             tiles_x, int(tile_offset), _ptr(out),
                             _build.stream_of(slots8))
    _build.check(lib, err, "vtgs_splat_fwd launch")
    _build.count_launch(splat_forward)
    return out


splat_forward.launches = 0


def _splat_backward(name, wrapper, plain, out_shape, slots8, R9, trans, counts,
                    out, g, cam, tiles_x, tile_ids, tile_offset):
    cp = cp_vector(R9, trans, cam)
    T, _, M = slots8.shape
    if slots8.device.type == "cpu":
        return plain(slots8, counts, cp, tiles_x, out, g, image_tiles(
            T, tile_ids, tile_offset, slots8.device))
    g = g.contiguous()
    _check_inputs(slots8, counts, cp, out, g)
    tids = check_tile_ids(tile_ids, T, slots8.device)
    res = torch.empty(out_shape(T, M), dtype=torch.float32,
                      device=slots8.device)
    lib = _build.library("splat")
    err = getattr(lib, name)(_ptr(slots8), _ptr(counts), tids, _ptr(cp),
                             _ptr(out), _ptr(g), T, M, tiles_x,
                             int(tile_offset), _ptr(res),
                             _build.stream_of(slots8))
    _build.check(lib, err, f"{name} launch")
    _build.count_launch(wrapper)
    return res


def splat_backward_pose(slots8, R9, trans, counts, out, g, cam: Camera,
                        tiles_x: int, tile_ids=None,
                        tile_offset: int = 0) -> torch.Tensor:
    """K2: replay + pose chain -> (T, 12) per-tile [dR(9), dt(3)] partials.
    A row of count 0 gives zeros whatever its cotangent."""
    return _splat_backward("vtgs_splat_bwd_pose", splat_backward_pose,
                           splat_backward_pose_plain, lambda T, M: (T, 12),
                           slots8, R9, trans, counts, out, g, cam, tiles_x,
                           tile_ids, tile_offset)


splat_backward_pose.launches = 0


def splat_backward_vals_rows(slots8, R9, trans, counts, out, g, cam: Camera,
                             tiles_x: int, tile_ids=None,
                             tile_offset: int = 0) -> torch.Tensor:
    """K3: replay without the mean chain -> (T, mpt, 8) per-slot rows."""
    return _splat_backward("vtgs_splat_bwd_vals_rows", splat_backward_vals_rows,
                           splat_backward_vals_rows_plain,
                           lambda T, M: (T, M, 8),
                           slots8, R9, trans, counts, out, g, cam, tiles_x,
                           tile_ids, tile_offset)


splat_backward_vals_rows.launches = 0


def splat_backward_all(slots8, R9, trans, counts, out, g, cam: Camera,
                       tiles_x: int, tile_ids=None,
                       tile_offset: int = 0) -> torch.Tensor:
    """K6: replay + full per-slot chain -> (T, 8, mpt) camera-frame rows."""
    return _splat_backward("vtgs_splat_bwd_all", splat_backward_all,
                           splat_backward_all_plain, lambda T, M: (T, 8, M),
                           slots8, R9, trans, counts, out, g, cam, tiles_x,
                           tile_ids, tile_offset)


splat_backward_all.launches = 0

GRAD_MODES = ("pose", "vals", "vals_rows", "all")


class SplatBlend(torch.autograd.Function):
    """accum = K1(slots8, R9, trans); the backward by grad_mode (module
    docstring) gives (d slots8, d R9, d trans)."""

    @staticmethod
    def forward(ctx, slots8, R9, trans, counts, cam, tiles_x, grad_mode):
        out = splat_forward(slots8, R9.detach(), trans.detach(), counts, cam,
                            tiles_x)
        ctx.save_for_backward(slots8, R9.detach(), trans.detach(), counts, out)
        ctx.cam, ctx.tiles_x, ctx.grad_mode = cam, tiles_x, grad_mode
        return out

    @staticmethod
    def backward(ctx, g):
        slots8, R9, trans, counts, out = ctx.saved_tensors
        args = (slots8, R9, trans, counts, out, g, ctx.cam, ctx.tiles_x)
        g_slots = g_R = g_t = None
        if ctx.grad_mode == "pose":
            tot = splat_backward_pose(*args).sum(0)
            g_R, g_t = tot[:9], tot[9:12]
        elif ctx.grad_mode == "all":
            rows = splat_backward_all(*args)
            g_mc = rows[:, 0:3]                                  # (T, 3, M)
            g_R = torch.einsum("tim,tjm->ij", g_mc, slots8[:, 0:3]).reshape(9)
            g_t = g_mc.sum((0, 2))
            g_w = torch.einsum("ij,tjm->tim", R9.reshape(3, 3).T, g_mc)
            g_slots = torch.cat([g_w, rows[:, 3:]], 1)
        else:
            g_slots = splat_backward_vals_rows(*args).transpose(1, 2)
            g_R, g_t = torch.zeros_like(R9), torch.zeros_like(trans)
        return g_slots, g_R, g_t, None, None, None, None


def splat_blend(slots8: torch.Tensor, R9: torch.Tensor, trans: torch.Tensor,
                counts: torch.Tensor, cam: Camera, tiles_x: int,
                grad_mode: str = "all") -> torch.Tensor:
    """slots8 (T, 8, mpt) + pose -> accum (T, 8, 256), differentiable in
    what `grad_mode` names: "pose" (R9, trans), "vals" / "vals_rows" (the
    slots' value rows; mean rows zero) or "all" (slots, R9 and trans)."""
    if grad_mode not in GRAD_MODES:
        raise ValueError(f"grad_mode must be one of {GRAD_MODES}, "
                         f"got {grad_mode!r}")
    return SplatBlend.apply(slots8, R9, trans, counts, cam, tiles_x, grad_mode)


def assemble_image(accum: torch.Tensor, cam: Camera, tile: int = TILE
                   ) -> torch.Tensor:
    """(T, 8, 256) channel-major accum -> (6, H, W) image."""
    tiles_x = -(-cam.width // tile)
    tiles_y = -(-cam.height // tile)
    n_tiles = tiles_x * tiles_y
    img = accum[:n_tiles, :6, :].reshape(tiles_y, tiles_x, 6, tile, tile)
    img = img.permute(2, 0, 3, 1, 4).reshape(6, tiles_y * tile, tiles_x * tile)
    return img[:, :cam.height, :cam.width]
