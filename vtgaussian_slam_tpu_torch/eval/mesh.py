"""TSDF fusion, iso-surface extraction and mesh metrics (the eval-only
mesh path).

Parity: `vtgaussian_slam_tpu/eval/mesh.py` (the reference's TSDF volume,
marching cubes, mesh cleaning and 2D depth metric).

- `TSDFVolume`: a dense voxel grid on the device over the observed
  bounds, integrated one RGB-D frame at a time by a projective update
  (voxel -> camera, SDF truncated at `sdf_trunc`, running weighted mean).
  The integrate runs in slabs along x: every voxel's update is independent,
  so slabbing bounds the temporaries (a whole 700 x 700 x 400 grid at once
  would need tens of GB) and changes no value.
- `marching_cubes`: marching TETRAHEDRA (6 tets per cube, watertight) as
  PyTorch ops on the volume's device, in the volume's dtype for the edge
  parameter and float64 for the vertices, as numpy promotes them in the
  JAX package: candidate cells in row-major order (`torch.nonzero` lists
  them as `np.argwhere` does), the 6 tets and 14 cases in the same order,
  and the duplicate vertices welded through a lexicographic unique of
  their int64 keys (`torch.unique(dim=0)` sorts as `np.unique(axis=0)`),
  so the faces are the JAX package's.
- `render_mesh_depth`: a z-buffer rasterizer on the device; the buffer
  takes the minimum over every face's fragments (`scatter_reduce_` with
  "amin"), which does not depend on their order.
- `clean_mesh`, `sample_surface`, `accuracy_completion`,
  `subdivide_to_edge`, `icp_align` and `calc_2d_metric`'s camera sampling
  run on the host in numpy / scipy, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.common import resolve_device

# voxels per integrate slab (about 1 GB of temporaries)
SLAB_VOXELS = 1 << 24


class TSDFVolume:
    def __init__(self, bounds_min, bounds_max, voxel_length: float = 5.0 / 512,
                 sdf_trunc: float = 0.04, depth_trunc: float = 16.0,
                 device="cuda", slab_voxels: int = SLAB_VOXELS):
        self.device = resolve_device(device)
        self.origin = np.asarray(bounds_min, np.float32)
        self.voxel = float(voxel_length)
        self.trunc = float(sdf_trunc)
        self.depth_trunc = float(depth_trunc)
        dims = np.ceil((np.asarray(bounds_max) - self.origin) / self.voxel
                       ).astype(int) + 1
        self.dims = tuple(int(d) for d in dims)
        self.slab = max(1, int(slab_voxels) // (self.dims[1] * self.dims[2]))
        self.tsdf = torch.ones(self.dims, device=self.device)
        self.weight = torch.zeros(self.dims, device=self.device)
        self.color = torch.zeros(self.dims + (3,), device=self.device)

    @property
    def state_bytes(self) -> int:
        return sum(x.numel() * x.element_size()
                   for x in (self.tsdf, self.weight, self.color))

    def integrate(self, color, depth, intrinsics, w2c):
        """color (H, W, 3) in [0, 1], depth (H, W) metres, w2c 4x4."""
        f32 = dict(dtype=torch.float32, device=self.device)
        color = torch.as_tensor(color).to(**f32)
        depth = torch.as_tensor(depth).to(**f32)
        K = torch.as_tensor(np.asarray(intrinsics, np.float32)).to(**f32)
        w2c = torch.as_tensor(np.asarray(w2c, np.float32)).to(**f32)
        origin = torch.as_tensor(self.origin).to(**f32)
        for x0 in range(0, self.dims[0], self.slab):
            x1 = min(x0 + self.slab, self.dims[0])
            _integrate(self.tsdf[x0:x1], self.weight[x0:x1],
                       self.color[x0:x1], color, depth, K, w2c, origin, x0,
                       self.voxel, self.trunc, self.depth_trunc)

    def extract_mesh(self):
        """(verts (V, 3) world metres float64, faces (F, 3) int64), numpy."""
        tsdf = torch.where(self.weight > 0, self.tsdf,
                           torch.full_like(self.tsdf, float("nan")))
        verts, faces = marching_cubes(tsdf, level=0.0)
        return verts * self.voxel + self.origin, faces

    def vertex_colors(self, verts_world: np.ndarray) -> np.ndarray:
        """Nearest-voxel colour of world-space vertices (numpy)."""
        idx = np.round((verts_world - self.origin) / self.voxel).astype(int)
        idx = np.clip(idx, 0, np.array(self.dims) - 1)
        idx = torch.as_tensor(idx, device=self.device)
        return self.color[idx[:, 0], idx[:, 1], idx[:, 2]].cpu().numpy()


@torch.no_grad()
def _integrate(tsdf, weight, color_vol, color, depth, K, w2c, origin, x0,
               voxel, trunc, depth_trunc):
    """The projective TSDF update of the voxel slab starting at x index x0,
    in place on the slab's views."""
    dims = tsdf.shape
    H, W = depth.shape
    dev = tsdf.device
    ii, jj, kk = torch.meshgrid(
        torch.arange(x0, x0 + dims[0], device=dev),
        torch.arange(dims[1], device=dev), torch.arange(dims[2], device=dev),
        indexing="ij")
    pts = origin + voxel * torch.stack([ii, jj, kk], -1).to(torch.float32)
    # elementwise, not a matmul: a BLAS kernel chosen by the slab's shape
    # could round differently from one slab size to another
    R = w2c[:3, :3]
    pc = torch.addcmul(torch.addcmul(pts[..., 0:1] * R[:, 0], pts[..., 1:2],
                                     R[:, 1]), pts[..., 2:3], R[:, 2]) \
        + w2c[:3, 3]
    z = pc[..., 2]
    zs = torch.clamp(z, min=1e-6)
    u = K[0, 0] * pc[..., 0] / zs + K[0, 2]
    v = K[1, 1] * pc[..., 1] / zs + K[1, 2]
    ui = torch.round(u).to(torch.int64)
    vi = torch.round(v).to(torch.int64)
    inb = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H) & (z > 0)
    uc = torch.clamp(ui, 0, W - 1)
    vc = torch.clamp(vi, 0, H - 1)
    d = depth[vc, uc]
    sdf = d - z
    valid = inb & (d > 0) & (d < depth_trunc) & (sdf > -trunc)
    tsdf_new = torch.clamp(sdf / trunc, -1.0, 1.0)
    w_new = valid.to(torch.float32)
    w_tot = weight + w_new
    seen = w_tot > 0
    denom = torch.clamp(w_tot, min=1)
    tsdf.copy_(torch.where(seen, (tsdf * weight + tsdf_new * w_new) / denom,
                           tsdf))
    c = color[vc, uc]
    color_vol.copy_(torch.where(
        seen[..., None],
        (color_vol * weight[..., None] + c * w_new[..., None])
        / denom[..., None], color_vol))
    weight.copy_(w_tot)


# ---------------------------------------------------------------------------
# Iso-surface extraction: marching tetrahedra (6 tets per cube)
# ---------------------------------------------------------------------------
_CORNER = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
])

# the 6 tetrahedra decomposing a cube, all sharing the 0-6 diagonal so that
# neighbouring cubes tile compatibly
_TETS = np.array([
    [0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
    [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6],
])

# case table: code (bitmask of the tet's corners below the level) -> its
# triangles, each a list of edges (corner index pairs)
_MT_CASES = {
    1: [[(0, 1), (0, 2), (0, 3)]],
    2: [[(1, 0), (1, 3), (1, 2)]],
    3: [[(0, 2), (0, 3), (1, 3)], [(0, 2), (1, 3), (1, 2)]],
    4: [[(2, 0), (2, 1), (2, 3)]],
    5: [[(0, 1), (2, 1), (0, 3)], [(2, 1), (2, 3), (0, 3)]],
    6: [[(1, 0), (2, 0), (1, 3)], [(2, 0), (2, 3), (1, 3)]],
    7: [[(0, 3), (1, 3), (2, 3)]],
    8: [[(3, 0), (3, 2), (3, 1)]],
    9: [[(0, 1), (0, 2), (3, 2)], [(0, 1), (3, 2), (3, 1)]],
    10: [[(1, 0), (3, 0), (1, 2)], [(3, 0), (3, 2), (1, 2)]],
    11: [[(0, 2), (3, 2), (1, 2)]],
    12: [[(2, 0), (2, 1), (3, 1)], [(2, 0), (3, 1), (3, 0)]],
    13: [[(0, 1), (2, 1), (3, 1)]],
    14: [[(1, 0), (2, 0), (3, 0)]],
}


def _candidate_cells(vol: torch.Tensor, level: float,
                     slab_voxels: int = SLAB_VOXELS) -> torch.Tensor:
    """(M, 3) int64 cells whose 8 corners are all finite and straddle
    `level`, in row-major order; computed in slabs along x."""
    nx, ny, nz = vol.shape
    step = max(1, slab_voxels // max(ny * nz, 1))
    out = []
    for a in range(0, nx - 1, step):
        b = min(a + step, nx - 1)
        ok = vmin = vmax = None
        for dx, dy, dz in _CORNER:
            sub = vol[a + dx:b + dx, dy:ny - 1 + dy, dz:nz - 1 + dz]
            okc = torch.isfinite(sub)
            lo = torch.where(okc, sub, torch.full_like(sub, float("inf")))
            hi = torch.where(okc, sub, torch.full_like(sub, float("-inf")))
            if ok is None:
                ok, vmin, vmax = okc, lo, hi
            else:
                ok = ok & okc
                vmin = torch.minimum(vmin, lo)
                vmax = torch.maximum(vmax, hi)
        cells = torch.nonzero(ok & (vmin <= level) & (vmax >= level))
        cells[:, 0] += a
        out.append(cells)
    if not out:
        return torch.zeros((0, 3), dtype=torch.int64, device=vol.device)
    return torch.cat(out)


@torch.no_grad()
def marching_cubes(volume, level: float = 0.0):
    """The iso-surface of `volume` (3-D tensor or array, NaN = unobserved)
    at `level` by marching tetrahedra, computed on the volume's device.
    Returns numpy (verts (M, 3) float64 in voxel coordinates, faces (F, 3)
    int64)."""
    vol = torch.as_tensor(volume)
    empty = (np.zeros((0, 3)), np.zeros((0, 3), np.int64))
    cells = _candidate_cells(vol, level)
    if len(cells) == 0:
        return empty
    dev = vol.device
    corner = torch.as_tensor(_CORNER, device=dev)
    corner_vals = torch.stack(
        [vol[cells[:, 0] + int(dx), cells[:, 1] + int(dy),
             cells[:, 2] + int(dz)] for dx, dy, dz in _CORNER], -1)
    base_all = cells.to(torch.float64)
    bits = torch.tensor([1, 2, 4, 8], device=dev)
    tiny = torch.tensor(1e-12, dtype=vol.dtype, device=dev)
    verts_out, faces_out = [], []
    vert_count = 0
    for tet in _TETS:
        tv = corner_vals[:, torch.as_tensor(tet, device=dev)]   # (M, 4)
        code = ((tv < level).to(torch.int64) * bits).sum(-1)
        tp = corner[torch.as_tensor(tet, device=dev)].to(torch.float64)
        for case, tris in _MT_CASES.items():
            sel = torch.nonzero(code == case).flatten()
            n = int(sel.numel())
            if n == 0:
                continue
            base = base_all[sel]
            tsel = tv[sel]

            def interp(i, j):
                a, b = tsel[:, i], tsel[:, j]
                t = (level - a) / torch.where((b - a).abs() < 1e-12, tiny,
                                              b - a)
                t = torch.clamp(t, 0.0, 1.0).to(torch.float64)[:, None]
                return base + tp[i] + t * (tp[j] - tp[i])

            for tri in tris:
                verts_out.extend(interp(i, j) for i, j in tri)
                idx = torch.arange(n, device=dev) + vert_count
                faces_out.append(torch.stack([idx, idx + n, idx + 2 * n], -1))
                vert_count += 3 * n
    if not verts_out:
        return empty
    verts = torch.cat(verts_out)
    faces = torch.cat(faces_out)
    # weld duplicate vertices: unique keys in lexicographic order, each
    # kept at its first occurrence
    key = torch.round(verts / 1e-6).to(torch.int64)
    uniq, inv = torch.unique(key, dim=0, return_inverse=True)
    first = torch.full((uniq.shape[0],), verts.shape[0], dtype=torch.int64,
                       device=dev)
    first.scatter_reduce_(0, inv, torch.arange(verts.shape[0], device=dev),
                          "amin")
    return verts[first].cpu().numpy(), inv[faces].cpu().numpy()


def clean_mesh(verts: np.ndarray, faces: np.ndarray, min_verts: int = 200):
    """Drop connected components with fewer than `min_verts` vertices,
    keeping every face that touches a kept component (the reference's
    threshold semantics); host scipy."""
    if len(faces) == 0:
        return verts, faces
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    n = len(verts)
    rows = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    cols = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    adj = sp.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    n_comp, labels = csgraph.connected_components(adj, directed=False)
    comp_sizes = np.bincount(labels, minlength=n_comp)
    vert_keep = comp_sizes[labels] >= min_verts
    keep = vert_keep[faces].any(axis=1)
    faces = faces[keep]
    used = np.unique(faces)
    remap = -np.ones(n, int)
    remap[used] = np.arange(len(used))
    return verts[used], remap[faces]


def sample_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                   seed: int = 0) -> np.ndarray:
    """Uniform area-weighted surface samples."""
    rng = np.random.default_rng(seed)
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    if area.sum() == 0:
        return verts[:n] if len(verts) else np.zeros((0, 3))
    probs = area / area.sum()
    idx = rng.choice(len(faces), size=n, p=probs)
    r1 = np.sqrt(rng.uniform(size=(n, 1)))
    r2 = rng.uniform(size=(n, 1))
    return (1 - r1) * v0[idx] + r1 * (1 - r2) * v1[idx] + r1 * r2 * v2[idx]


def accuracy_completion(rec_verts, rec_faces, gt_verts, gt_faces,
                        n_samples: int = 200000, seed: int = 0):
    """(accuracy, completion) in metres: the mean nearest-neighbour distance
    reconstruction -> GT and GT -> reconstruction over surface samples."""
    from scipy.spatial import cKDTree

    rp = sample_surface(rec_verts, rec_faces, n_samples, seed)
    gp = sample_surface(gt_verts, gt_faces, n_samples, seed + 1)
    acc = cKDTree(gp).query(rp)[0].mean() if len(rp) else np.inf
    comp = cKDTree(rp).query(gp)[0].mean() if len(gp) else np.inf
    return float(acc), float(comp)


@torch.no_grad()
def render_mesh_depth(verts, faces, w2c, K, h: int, w: int, span: int = 16,
                      chunk: int = 8192) -> torch.Tensor:
    """Z-buffer depth (h, w) of a triangle mesh, 0 where no surface, on the
    vertices' device. Each face fills a `span` x `span` pixel window at
    its screen box's corner with perspective-correct barycentric depth,
    `chunk` faces at a time; a face wider than `span` pixels is filled
    only in part (`calc_2d_metric` subdivides first)."""
    verts = torch.as_tensor(verts)
    dev = verts.device
    verts = verts.to(torch.float32)
    faces = torch.as_tensor(faces, device=dev).to(torch.int64)
    w2c = torch.as_tensor(w2c).to(device=dev, dtype=torch.float32)
    K = torch.as_tensor(K).to(device=dev, dtype=torch.float32)
    near = 1e-4
    zbuf = torch.full((h * w,), float("inf"), device=dev)
    if faces.shape[0] == 0:
        return torch.zeros((h, w), device=dev)
    vc = verts @ w2c[:3, :3].T + w2c[:3, 3]
    z = vc[:, 2]
    front = z > near
    zs = torch.where(front, z, torch.ones_like(z))
    u = K[0, 0] * vc[:, 0] / zs + K[0, 2]
    v = K[1, 1] * vc[:, 1] / zs + K[1, 2]
    inv_z = torch.where(front, 1.0 / zs, torch.zeros_like(zs))
    sy = torch.arange(span, device=dev)[:, None]
    sx = torch.arange(span, device=dev)[None, :]
    for c0 in range(0, faces.shape[0], chunk):
        f = faces[c0:c0 + chunk]
        i0, i1, i2 = f[:, 0], f[:, 1], f[:, 2]
        u0, u1, u2 = u[i0], u[i1], u[i2]
        v0, v1, v2 = v[i0], v[i1], v[i2]
        w0, w1, w2 = inv_z[i0], inv_z[i1], inv_z[i2]
        fvalid = front[i0] & front[i1] & front[i2]
        xi0 = torch.clamp(torch.floor(torch.minimum(torch.minimum(u0, u1), u2)),
                          0, w - 1).to(torch.int64)
        yi0 = torch.clamp(torch.floor(torch.minimum(torch.minimum(v0, v1), v2)),
                          0, h - 1).to(torch.int64)
        px = (xi0[:, None, None] + sx[None]).to(torch.float32)
        py = (yi0[:, None, None] + sy[None]).to(torch.float32)
        area = (u1 - u0) * (v2 - v0) - (v1 - v0) * (u2 - u0)
        ok_area = area.abs() > 1e-12
        inv_area = 1.0 / torch.where(ok_area, area, torch.ones_like(area))

        def edge(ua, va, ub, vb):
            return ((ub - ua)[:, None, None] * (py - va[:, None, None])
                    - (vb - va)[:, None, None] * (px - ua[:, None, None]))

        l0 = edge(u1, v1, u2, v2) * inv_area[:, None, None]
        l1 = edge(u2, v2, u0, v0) * inv_area[:, None, None]
        l2 = edge(u0, v0, u1, v1) * inv_area[:, None, None]
        eps = -1e-6
        inside = (l0 >= eps) & (l1 >= eps) & (l2 >= eps)
        inside &= (fvalid & ok_area)[:, None, None]
        inside &= (px < w) & (py < h)
        inv_depth = (l0 * w0[:, None, None] + l1 * w1[:, None, None]
                     + l2 * w2[:, None, None])
        inside &= inv_depth > near
        depth = 1.0 / torch.where(inside, inv_depth, torch.ones_like(inv_depth))
        depth = torch.where(inside, depth, torch.full_like(depth, float("inf")))
        flat = py.to(torch.int64) * w + px.to(torch.int64)
        # fragments outside the image carry inf: park them on pixel 0,
        # where a min with inf changes nothing
        flat = torch.where(inside, flat, torch.zeros_like(flat))
        zbuf.scatter_reduce_(0, flat.reshape(-1), depth.reshape(-1), "amin")
    return torch.where(torch.isfinite(zbuf), zbuf,
                       torch.zeros_like(zbuf)).reshape(h, w)


def subdivide_to_edge(verts: np.ndarray, faces: np.ndarray,
                      max_edge: float, max_rounds: int | None = None):
    """Midpoint 1 -> 4 subdivision of faces whose longest edge exceeds
    `max_edge`, for as many rounds as the longest edge needs (each round
    halves it)."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    if max_rounds is None:
        if len(faces):
            e = verts[faces]
            longest = max(
                float(np.linalg.norm(e[:, 0] - e[:, 1], axis=1).max()),
                float(np.linalg.norm(e[:, 1] - e[:, 2], axis=1).max()),
                float(np.linalg.norm(e[:, 2] - e[:, 0], axis=1).max()))
            max_rounds = max(int(np.ceil(np.log2(
                max(longest / max(max_edge, 1e-9), 1.0)))), 0) + 1
        else:
            max_rounds = 0
    for _ in range(max_rounds):
        if len(faces) == 0:
            break
        e = verts[faces]
        longest = np.maximum(
            np.linalg.norm(e[:, 0] - e[:, 1], axis=1),
            np.maximum(np.linalg.norm(e[:, 1] - e[:, 2], axis=1),
                       np.linalg.norm(e[:, 2] - e[:, 0], axis=1)))
        big = longest > max_edge
        if not big.any():
            break
        keep = faces[~big]
        fb = faces[big]
        v0, v1, v2 = verts[fb[:, 0]], verts[fb[:, 1]], verts[fb[:, 2]]
        m01, m12, m20 = (v0 + v1) / 2, (v1 + v2) / 2, (v2 + v0) / 2
        base = len(verts)
        nb = len(fb)
        verts = np.concatenate([verts, m01, m12, m20])
        a, b, c = fb[:, 0], fb[:, 1], fb[:, 2]
        i01 = base + np.arange(nb)
        i12 = base + nb + np.arange(nb)
        i20 = base + 2 * nb + np.arange(nb)
        new = np.concatenate([
            np.stack([a, i01, i20], 1), np.stack([i01, b, i12], 1),
            np.stack([i20, i12, c], 1), np.stack([i01, i12, i20], 1)])
        faces = np.concatenate([keep, new])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def icp_align(src_pts: np.ndarray, dst_pts: np.ndarray,
              threshold: float = 0.1, iters: int = 30) -> np.ndarray:
    """Point-to-point ICP (host scipy): the 4x4 transform aligning src onto
    dst."""
    from scipy.spatial import cKDTree

    T = np.eye(4)
    cur = src_pts.copy()
    tree = cKDTree(dst_pts)
    prev_err = np.inf
    for _ in range(iters):
        d, idx = tree.query(cur)
        m = d < threshold
        if m.sum() < 10:
            break
        p, q = cur[m], dst_pts[idx[m]]
        pc, qc = p.mean(0), q.mean(0)
        U, _, Vt = np.linalg.svd((p - pc).T @ (q - qc))
        R = Vt.T @ U.T
        if np.linalg.det(R) < 0:
            Vt[-1] *= -1
            R = Vt.T @ U.T
        t = qc - R @ pc
        step = np.eye(4)
        step[:3, :3], step[:3, 3] = R, t
        T = step @ T
        cur = cur @ R.T + t
        err = d[m].mean()
        if prev_err - err < 1e-7:
            break
        prev_err = err
    return T


def _oriented_camera_box(gt_verts: np.ndarray):
    """PCA oriented box of the GT mesh shrunk to the room's vacant interior
    as the reference does (extents x [0.3, 0.7, 0.7], lifted 0.4 m)."""
    c = gt_verts.mean(0)
    centered = gt_verts - c
    _, _, Vt = np.linalg.svd(centered[:: max(1, len(gt_verts) // 50000)],
                             full_matrices=False)
    proj = centered @ Vt.T
    lo, hi = proj.min(0), proj.max(0)
    extents = (hi - lo) * np.array([0.3, 0.7, 0.7])
    transform = np.eye(4)
    transform[:3, :3] = Vt.T
    transform[:3, 3] = c + Vt.T @ ((lo + hi) / 2)
    transform[2, 3] += 0.4
    return extents, transform


def _lookat_w2c(origin: np.ndarray, target: np.ndarray,
                up=(0.0, 0.0, -1.0)) -> np.ndarray:
    fwd = target - origin
    fwd = fwd / (np.linalg.norm(fwd) + 1e-12)
    right = np.cross(np.asarray(up, np.float64), fwd)
    n = np.linalg.norm(right)
    if n < 1e-6:
        right = np.cross([0.0, 1.0, 0.0], fwd)
        n = np.linalg.norm(right)
    right /= n
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, origin
    return np.linalg.inv(c2w)


def calc_2d_metric(rec_verts, rec_faces, gt_verts, gt_faces,
                   pc_unseen: np.ndarray | None = None,
                   n_imgs: int = 1000, align: bool = True, seed: int = 0,
                   h: int = 500, w: int = 500, focal: float = 300.0,
                   max_edge: float = 0.05, max_tries: int = 200,
                   device="cuda") -> dict:
    """Unseen-aware 2D depth L1 between a reconstructed and a GT mesh:
    `n_imgs` random in-room views (origins uniform in the GT room's shrunk
    oriented box, looking at a random direction), views that see any
    `pc_unseen` point rejected, both meshes' depth rendered on `device` and
    |gt - rec| averaged over the pixels the reconstruction covers. Returns
    {"depth l1": cm}. Cameras are +z-forward w2c, as everywhere in the
    package."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    K = np.array([[focal, 0, w / 2.0 - 0.5],
                  [0, focal, h / 2.0 - 0.5], [0, 0, 1.0]], np.float32)
    if align and len(rec_verts) and len(gt_verts):
        T = icp_align(
            rec_verts[:: max(1, len(rec_verts) // 20000)].astype(np.float64),
            gt_verts[:: max(1, len(gt_verts) // 20000)].astype(np.float64))
        rec_verts = rec_verts @ T[:3, :3].T + T[:3, 3]

    rec_verts, rec_faces = subdivide_to_edge(rec_verts, rec_faces, max_edge)
    gt_verts, gt_faces = subdivide_to_edge(gt_verts, gt_faces, max_edge)
    rv = torch.as_tensor(rec_verts, device=dev)
    rf = torch.as_tensor(rec_faces, device=dev)
    gv = torch.as_tensor(gt_verts, device=dev)
    gf = torch.as_tensor(gt_faces, device=dev)
    Kt = torch.as_tensor(K, device=dev)
    extents, transform = _oriented_camera_box(np.asarray(gt_verts))

    errors = []
    for _ in range(n_imgs):
        w2c = None
        for _try in range(max_tries):
            local = (rng.uniform(-0.5, 0.5, 3)) * extents
            origin = transform[:3, :3] @ local + transform[:3, 3]
            target = rng.uniform(-10000, 10000, 3)
            cand = _lookat_w2c(origin, target)
            if pc_unseen is not None and len(pc_unseen):
                pc = pc_unseen @ cand[:3, :3].T + cand[:3, 3]
                zp = pc[:, 2]
                uv = pc[:, :2] / np.maximum(zp[:, None], 1e-5)
                uu = uv[:, 0] * focal + K[0, 2]
                vv = uv[:, 1] * focal + K[1, 2]
                seen = ((zp > 0) & (uu > 0) & (uu < w)
                        & (vv > 0) & (vv < h)).any()
                if seen:
                    continue
            w2c = cand
            break
        if w2c is None:
            continue
        w2c_t = torch.as_tensor(w2c, dtype=torch.float32, device=dev)
        gt_d = render_mesh_depth(gv, gf, w2c_t, Kt, h, w)
        rec_d = render_mesh_depth(rv, rf, w2c_t, Kt, h, w)
        m = rec_d > 0
        if bool(m.any()):
            errors.append(float((gt_d[m] - rec_d[m]).abs().mean()))
    return {"depth l1": float(np.mean(errors) * 100) if errors
            else float("nan")}
