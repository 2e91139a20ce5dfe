"""Shared inputs for the tests that hold the PyTorch port against the JAX
package: small scenes made from a numpy seed, handed to both sides."""
import importlib.util
import os

import numpy as np
import pytest
import torch

# 40 x 48 pixels: 3 x 3 tiles, with H not a multiple of 16
H, W = 40, 48
FX = FY = 48.0
CX, CY = 24.0, 20.0
TILES_X = 3
N_TILES = 9


def jax_cam():
    from vtgaussian_slam_tpu.ops.camera import Camera
    return Camera(height=H, width=W, fx=FX, fy=FY, cx=CX, cy=CY)


def torch_cam():
    from vtgaussian_slam_tpu_torch.ops.camera import Camera
    return Camera(height=H, width=W, fx=FX, fy=FY, cx=CX, cy=CY)


def scene_np(n=400, seed=0, logit_lo=-1.0, logit_hi=3.0, scale_lo=-3.2,
             scale_hi=-2.2):
    """Reference-format params (section_to_numpy_params keys) of n isotropic
    Gaussians in front of the camera."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.5, 3.5, n)
    u = rng.uniform(-4.0, W + 4.0, n)
    v = rng.uniform(-4.0, H + 4.0, n)
    means = np.stack([(u - CX) / FX * z, (v - CY) / FY * z, z], -1)
    rot = np.tile(np.array([[1.0, 0, 0, 0]]), (n, 1))
    return {
        "means3D": means.astype(np.float32),
        "rgb_colors": rng.uniform(0, 1, (n, 3)).astype(np.float32),
        "unnorm_rotations": rot.astype(np.float32),
        "logit_opacities": rng.uniform(logit_lo, logit_hi, (n, 1)).astype(
            np.float32),
        "log_scales": rng.uniform(scale_lo, scale_hi, (n, 1)).astype(
            np.float32),
        "cam_unnorm_rots": np.array([[[1.0], [0.0], [0.0], [0.0]]], np.float32),
        "cam_trans": np.zeros((1, 3, 1), np.float32),
    }


def crowded_scene_np(n=900, seed=7, height=48, width=64, fx=50.0):
    """Reference-format isotropic Gaussians crowded towards the left edge
    of a height x width camera of focal fx centred on the image (u ~ U^2),
    so tile counts are heavy-tailed: the two-class tests' scene."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.5, 3.5, n)
    u = 2.0 + (width - 4.0) * rng.uniform(0, 1, n) ** 2
    v = rng.uniform(2.0, height - 2.0, n)
    means = np.stack([(u - width / 2) / fx * z, (v - height / 2) / fx * z, z],
                     -1)
    return {"means3D": means.astype(np.float32),
            "rgb_colors": rng.uniform(0, 1, (n, 3)).astype(np.float32),
            "unnorm_rotations": np.tile(np.float32([[1, 0, 0, 0]]), (n, 1)),
            "logit_opacities": rng.normal(size=(n, 1)).astype(np.float32),
            "log_scales": rng.uniform(-3.4, -2.6, (n, 1)).astype(np.float32)}


def jax_params(p):
    import jax.numpy as jnp
    from vtgaussian_slam_tpu.models.gaussians import GaussianParams
    return GaussianParams(
        means3d=jnp.asarray(p["means3D"]), rgb_colors=jnp.asarray(p["rgb_colors"]),
        unnorm_rotations=jnp.asarray(p["unnorm_rotations"]),
        logit_opacities=jnp.asarray(p["logit_opacities"]),
        log_scales=jnp.asarray(p["log_scales"]))


def torch_params(p):
    from vtgaussian_slam_tpu_torch.models.gaussians import GaussianParams
    return GaussianParams(*[torch.as_tensor(np.asarray(p[k]).copy()) for k in (
        "means3D", "rgb_colors", "unnorm_rotations", "logit_opacities",
        "log_scales")])


def slots_at(px, py, z, sigma_px, logit, rgb, fx=FX, fy=FY, cx=CX, cy=CY):
    """(8, n) f32 slot rows [wx wy wz logit_op log_scale r g b] of isotropic
    Gaussians whose 2D means land on pixel coordinates (px, py) (the
    kernels' mean2d, pixel centres at integers) at depth z, about sigma_px
    pixels wide on screen, seen from the identity pose."""
    px, py, z, sig, lo = (np.asarray(v, np.float64) for v in
                          np.broadcast_arrays(px, py, z, sigma_px, logit))
    x = (px + 0.5 - cx) * z / fx
    y = (py + 0.5 - cy) * z / fy
    ls = np.log(sig * z / fx)
    rgb = np.broadcast_to(np.asarray(rgb, np.float64), px.shape + (3,))
    return np.stack([x, y, z, lo, ls, rgb[..., 0], rgb[..., 1], rgb[..., 2]]
                    ).astype(np.float32)


def random_tile_slots(tile_ids, tiles_x, mpt, seed, sigma=(1.0, 6.0), **cam):
    """(T, 8, mpt) slots for the tiles `tile_ids`: mpt depth-ordered
    Gaussians around each tile (means up to 8 px outside it), for the
    identity pose and the intrinsics in `cam` (default: the test camera)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((len(tile_ids), 8, mpt), np.float32)
    for i, t in enumerate(tile_ids):
        ty, tx = divmod(int(t), tiles_x)
        z = np.sort(rng.uniform(1.5, 3.5, mpt))
        out[i] = slots_at(tx * 16 + rng.uniform(-8, 24, mpt),
                          ty * 16 + rng.uniform(-8, 24, mpt), z,
                          rng.uniform(*sigma, mpt), rng.uniform(-1, 3, mpt),
                          rng.uniform(0, 1, (mpt, 3)), **cam)
    return out


def k5_records(seed, count_hi, op=(0.1, 0.99), conic=(0.05, 0.5), mpt=128,
               n_colors=8):
    """Random per-tile records (T, 16, mpt) + counts. With op[1] > 0.99
    every 8th record is fully opaque and centred on a pixel, so that pixel
    clamps (op * exp(power) > 0.99); small conics (wide splats) and high
    opacity end every pixel of a tile before the tile's count."""
    rng = np.random.default_rng(seed)
    recs = np.zeros((N_TILES, mpt, 16), np.float32)
    counts = rng.integers(5, count_hi + 1, N_TILES).astype(np.int32)
    counts[0] = count_hi
    for t in range(N_TILES):
        ty, tx = divmod(t, TILES_X)
        n = counts[t]
        recs[t, :n, 0] = tx * 16 + rng.uniform(-2, 18, n)
        recs[t, :n, 1] = ty * 16 + rng.uniform(-2, 18, n)
        a = rng.uniform(*conic, n)
        cc = rng.uniform(*conic, n)
        recs[t, :n, 2] = a
        recs[t, :n, 3] = rng.uniform(-0.1, 0.1, n) * np.sqrt(a * cc)
        recs[t, :n, 4] = cc
        recs[t, :n, 5] = rng.uniform(*op, n)
        recs[t, :n, 6:6 + n_colors] = rng.uniform(0, 1, (n, n_colors))
        if op[1] > 0.99:
            recs[t, :n:8, 5] = 1.0
            recs[t, :n:8, :2] = np.round(recs[t, :n:8, :2])
    return np.ascontiguousarray(recs.transpose(0, 2, 1)), counts


POSE_Q = np.array([0.999, 0.01, -0.02, 0.005], np.float32)
POSE_T = np.array([0.02, -0.01, 0.03], np.float32)


def np_(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close_scaled(got, ref, rtol, what=""):
    """|got - ref| <= rtol * max|ref| elementwise: for gradient sums whose
    small entries are cancellations of large terms."""
    got, ref = np_(got).astype(np.float64), np_(ref).astype(np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-12)
    err = np.abs(got - ref).max()
    assert err <= rtol * scale, f"{what}: max err {err:.3e} > {rtol} * {scale:.3e}"


FIELDS = ("rgb_colors", "logit_opacities", "log_scales")
# The engine-level yardstick. A trained field of the port is held against
# the JAX engine's, relative to how far the JAX engine moves from ITSELF
# when its input frames move by one ulp (`jax_spread`; S is the largest
# over three runs: depth, colour, both one ulp up). Per section and field,
# the share of entries outside the band 5e-4 + 1e-3 |b| may be at most
# SPREAD_K times S's share plus SPREAD_FLOOR; the largest difference at
# most SPREAD_K times S's largest (at least the band's 5e-4), and never
# past Adam's reach (lr x mapping iterations).
#
# Which S: a section's own where its runs read a spread (every nudged run
# keeps its Gaussian count and some field's share reaches SPREAD_FLOOR);
# else the largest over the run's sections. A nudge of the frames barely
# moves the projection of a section's own spawn keyframe (projecting the
# back-projected pixel undoes the depth's scale), so a section seen mostly
# from its spawn pose can read a spread near 0 while the port's rounding
# of that projection (as written, where XLA contracts it into an FMA)
# still flips which pairs a tile keeps: the tum-style run's section 0
# (logit S 0.0002, the port 0.0032). The largest difference is always held
# to the largest over the sections: it is one extreme entry, a Gaussian at
# a tile's edge that one side bins and the other not, moved a few Adam
# steps apart (the replica-style run's section 3: JAX's own runs move its
# logits by 0.018 at most, the port one Gaussian by 0.365 with half JAX's
# share outside the band; with XLA capped at AVX, no FMA, that entry's
# gap falls to 1.6e-3). Below Adam's reach it does not tell rounding from
# a fault; the share does (tests/test_torch_parity_controls.py, and
# test_torch_boundaries.py's control on the replica-style run).
#
# SPREAD_K was chosen from these measurements (CPU; port / S of the logit
# share outside the band, with the S each section is held to, and of the
# largest |delta|). Slice config (3 frames, 1 section), data seeds 1 / 2:
# share 0.31 / 0.57, max 0.34 / 0.11; with XLA capped at AVX 1.67 / 1.78
# and 0.22 / 0.08. Replica-style boundary run (10 frames, 4 sections;
# section 2 has no aligned run and takes the largest): share 0.45, 0.03,
# 0.21, 0.48, max 0.65; at AVX 0.96, 0.94, 1.16, 0.26, max 0.69.
# Tum-style (4 frames, 2 sections): share 0.07 (the largest), 0.92, max
# 0.77. One nudge is one sample of a chaotic process: a depth-only nudge
# gave a 2.5x smaller S than depth and colour together on the slice (seed
# 1), a colour-only one 150x smaller on the tum-style run's section 1.
# k = 3 leaves ~1.7x over the largest ratio seen. A one-section run on the
# generic route, which bins afresh at its spawn pose every iteration,
# showed port / S of 3.3 (test_torch_generic_engine, which keeps its own
# fixed threshold and holds it).
SPREAD_K = 3.0
SPREAD_FLOOR = 0.002


def band_gap(got, ref) -> tuple[float, float]:
    """(share of entries outside 5e-4 + 1e-3 |ref|, largest |got - ref|)."""
    got, ref = np_(got).astype(np.float64), np_(ref).astype(np.float64)
    d = np.abs(got - ref)
    return float((d > 5e-4 + 1e-3 * np.abs(ref)).mean()), float(d.max())


def section_fields(eng, port: bool) -> list:
    """[(n_active, {field: (n_active, ...) numpy array})] per section of a
    port or JAX engine (a paged-out section from its host copy)."""
    out = []
    for i, s in enumerate(eng.sections):
        if port and i in eng._paged:
            s = eng.host_section(i)
        n = int(s.n_active)
        out.append((n, {f: np_(getattr(s.params, f))[:n].copy()
                        for f in FIELDS}))
    return out


def one_ulp_frames(mp, depth=True, color=True):
    """Move every frame the JAX package's synthetic dataset returns one
    ulp up (depth where valid, colour), inside MonkeyPatch `mp`."""
    from vtgaussian_slam_tpu.datasets.synthetic import SyntheticRoomDataset
    get = SyntheticRoomDataset.__getitem__

    def nudged(self, index):
        c, d, K, pose = get(self, index)
        if depth:
            d = np.where(d > 0, np.nextafter(d, np.float32(np.inf)),
                         d).astype(d.dtype)
        if color:
            c = np.nextafter(c, np.float32(np.inf)).astype(c.dtype)
        return c, d, K, pose

    mp.setattr(SyntheticRoomDataset, "__getitem__", nudged)


def pin_jax_poses(mp, eng, poses, tracked=None):
    """After the JAX engine `eng` tracks frame t, put (quats, trans)[t] of
    `poses` into its trajectory (inside MonkeyPatch `mp`); the pose it
    tracked goes into `tracked[t]` when a dict is given."""
    import jax.numpy as jnp
    from vtgaussian_slam_tpu.core import pipeline as JP
    track = eng._track

    def pinned(t, frame, color_np):
        sec = track(t, frame, color_np)
        if tracked is not None:
            tracked[t] = (np.asarray(eng.traj.quats[t]).copy(),
                          np.asarray(eng.traj.trans[t]).copy())
        q, tr = (jnp.asarray(np.asarray(x[t])) for x in poses)
        nq, nt = JP._traj_write(eng.traj.quats, eng.traj.trans, t, q, tr)
        eng.traj = eng.traj.replace(quats=nq, trans=nt)
        return sec

    mp.setattr(eng, "_track", pinned)


NUDGES = {"depth": (True, False), "colour": (False, True),
          "both": (True, True)}


def jax_spread(cfg, frames: int, ref_sections, pin_poses=None) -> dict:
    """The JAX engine's own rounding spread: run it over `frames` frames
    three times, with the input frames' depth, colour, and both one ulp up
    (`one_ulp_frames`), and compare each section with `ref_sections`
    (`section_fields` of the unperturbed JAX run). With `pin_poses`
    ((quats, trans) of the unperturbed run), each tracked pose is replaced
    by the unperturbed one, as the boundary tests give the port the JAX
    engine's poses. Returns {nudge: per section {field: (share outside the
    band, largest |delta|)}, None for a section whose Gaussian count
    differs (no row alignment exists)}."""
    from vtgaussian_slam_tpu.core import pipeline as JP
    from vtgaussian_slam_tpu.ops import image as JI
    runs = {}
    for name, (depth, color) in NUDGES.items():
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JI, "cv2", None)      # the numpy Canny, as the tests
            one_ulp_frames(mp, depth, color)
            eng = JP.VTGaussianSLAM(cfg)
            if pin_poses is not None:
                pin_jax_poses(mp, eng, pin_poses)
            for t in range(frames):
                if t == 0:
                    eng.process_frame_zero()
                else:
                    eng.process_frame(t)
            eng._page_cold_finish()
            nudged = section_fields(eng, False)
        runs[name] = [
            {f: band_gap(nudged[i][1][f], ref[f]) for f in FIELDS}
            if i < len(nudged) and nudged[i][0] == n else None
            for i, (n, ref) in enumerate(ref_sections)]
    return runs


def _largest(gaps) -> dict:
    """{field: (largest share, largest |delta|)} over a list of gap dicts."""
    return {f: (max(g[f][0] for g in gaps), max(g[f][1] for g in gaps))
            for f in FIELDS}


def assert_fields_within_spread(port_sections, jax_sections, runs, lrs,
                                mapping_iters):
    """Every section's trained fields against the JAX engine's on the
    yardstick above (`runs` from `jax_spread`), and every entry within
    Adam's reach (lr x mapping iterations): an outlier past the reach is a
    fault, not rounding."""
    per_section = [[r[i] for r in runs.values() if r[i] is not None]
                   for i in range(len(jax_sections))]
    known = [g for gaps in per_section for g in gaps]
    assert known, "no section of the nudged JAX runs lines up with the run"
    pooled = _largest(known)
    for i, ((n_t, tp), (n_j, jp)) in enumerate(zip(port_sections,
                                                   jax_sections)):
        assert n_t == n_j, (i, n_t, n_j)
        own = (_largest(per_section[i])
               if len(per_section[i]) == len(runs) else None)
        reads = own is not None and any(own[f][0] >= SPREAD_FLOOR
                                        for f in FIELDS)
        for f in FIELDS:
            share, big = band_gap(tp[f], jp[f])
            s_share = (own if reads else pooled)[f][0]
            reach = lrs[f] * mapping_iters
            assert share <= SPREAD_K * s_share + SPREAD_FLOOR, (
                i, f, share, s_share, reads)
            assert big <= max(SPREAD_K * pooled[f][1], 5e-4), (
                i, f, big, pooled[f][1])
            assert big <= reach, (i, f, big, reach)


def _w2c64(traj) -> np.ndarray:
    """(T, 4, 4) f64 w2c of a port or JAX trajectory's f32 poses."""
    from vtgaussian_slam_tpu_torch.ops import geometry as geo
    q = torch.as_tensor(np_(traj.quats).astype(np.float64))
    t = torch.as_tensor(np_(traj.trans).astype(np.float64))
    return np_(geo.pose_to_w2c(geo.normalize(q), t))


def assert_means_at_own_poses(t_sec, j_sec, t_traj, j_traj, n) -> None:
    """The first n means of a port section against the JAX engine's, each
    held at the pose it was built from. Every Gaussian carries its frame of
    origin (`vars.timestep`): a densified one is back-projected at that
    frame's tracked pose, a base-frame section's at the boundary's, frame
    0's at the identity. The frames of origin must agree exactly; then the
    port's mean goes through the port's own w2c at that frame and JAX's c2w
    at the same frame, in f64: m' = c2w_jax[t] . w2c_port[t] . m_port, held
    against JAX's mean at rtol = atol = 1e-5. The pose gap drops
    out exactly; the pose checks hold it, once, at their own tolerance.

    Held directly, a densified mean carries the pose gap of its frame
    through a ~4 m back-projection, about 3x the gap (|dt| + 2 |dq| z).
    The slice config (3 frames), frame 2, by host (CPU; XLA capped at AVX
    has no FMA): default, |dq| 1.4e-7, |dt| 6.0e-7, means 1.9e-6 (0.17 of
    the 1e-5 band); AVX, |dq| 3.3e-6, |dt| 1.3e-5, means 4.1e-5 (4.0 of
    it), while the pose gap there is 15x inside its own tolerance (2e-4).
    Prints the largest gap over its tolerance."""
    ts = np_(t_sec.vars.timestep)[:n]
    np.testing.assert_array_equal(ts, np_(j_sec.vars.timestep)[:n],
                                  err_msg="frames of origin")
    frame = ts.astype(np.int64)
    to_jax = np.linalg.inv(_w2c64(j_traj))[frame] @ _w2c64(t_traj)[frame]
    m = np_(t_sec.params.means3d)[:n].astype(np.float64)
    got = np.einsum("nij,nj->ni", to_jax[:, :3, :3], m) + to_jax[:, :3, 3]
    ref = np_(j_sec.params.means3d)[:n].astype(np.float64)
    tol = 1e-5
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol,
                               err_msg="means at their own poses")
    ratio = (np.abs(got - ref) / (tol + tol * np.abs(ref))).max(initial=0.0)
    print(f"means at their own poses: largest gap / tolerance {ratio:.3f}")


@pytest.fixture(autouse=True, scope="module")
def first_exp_spent():
    """In a process that also imports JAX, the first multi-threaded
    `torch.exp` on the CPU can come back ~1e-4 off on one thread's share of
    the tensor; later calls are exact. A module that compares at 1e-5 or
    tighter imports this fixture to spend that first call."""
    torch.exp(torch.randn(1 << 20))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """A module that runs whole engines or heavy torch ops on the CPU
    imports this fixture: one intra-op thread, so that pytest-xdist's
    workers (each with torch's default of a thread per core) do not
    oversubscribe the cores; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke_config(workdir, frames=8, height=24, width=32, iters=3, **over):
    """configs/synthetic/smoke.py cut to `frames` frames of height x width
    and `iters` tracking / mapping iterations, writing under `workdir`;
    `over` sets top-level entries (a dict value updates that entry)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "smoke_cfg", os.path.join(repo, "configs", "synthetic", "smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = mod.config
    cfg["workdir"] = str(workdir)
    cfg["data"]["synthetic"].update(num_frames=frames, height=height,
                                    width=width)
    cfg["data"]["desired_image_height"] = height
    cfg["data"]["desired_image_width"] = width
    cfg["tracking"]["num_iters"] = cfg["tracking"]["base1_num_iters"] = iters
    cfg["mapping"]["num_iters"] = iters
    for k, v in over.items():
        if isinstance(v, dict):
            cfg[k].update(v)
        else:
            cfg[k] = v
    return cfg
