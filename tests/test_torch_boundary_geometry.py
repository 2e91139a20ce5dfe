"""The geometry and section bookkeeping that section boundaries add, against
the JAX package, on numpy-seeded inputs.

- ops/geometry: `backproject_at` and `project_points` within 1e-6
  relative (the same f32 products); `depth_to_normals` within 1e-5 (a
  cross product of central differences, normalized); `frustum_mask` and
  `visibility_mask` equal but for points within 1e-4 px / 1e-5 relative of
  a threshold; `bilinear_sample` within 1e-6 (taps outside the image are
  zero on both sides);
- models/gaussians: `concat_sections` (active prefixes back to back,
  zero-padded to the capacity ladder, the last section's scene radius)
  and `split_section` (each original keeps its capacity) exactly;
- core/densify: `base_frame_pointcloud` at a tracked pose, with and
  without a mask, within 2e-6 (a few ulps of ~3 m coordinates)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import first_exp_spent, np_  # noqa: F401
from vtgaussian_slam_tpu.core import densify as JD
from vtgaussian_slam_tpu.core.losses import Frame as JFrame
from vtgaussian_slam_tpu.models import gaussians as JGS
from vtgaussian_slam_tpu.ops import geometry as JG
from vtgaussian_slam_tpu.ops.camera import Camera as JCam
from vtgaussian_slam_tpu_torch.core import densify as TD
from vtgaussian_slam_tpu_torch.core.losses import Frame as TFrame
from vtgaussian_slam_tpu_torch.models import gaussians as TGS
from vtgaussian_slam_tpu_torch.ops import geometry as TG
from vtgaussian_slam_tpu_torch.ops.camera import Camera as TCam

H, W = 30, 44
K = np.array([[40.0, 0, 21.5], [0, 41.0, 15.2], [0, 0, 1]], np.float32)


def _depth(seed, holes=0.1):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    d = 2.0 + 0.4 * np.sin(xx / 5.0 + seed) + 0.3 * np.cos(yy / 4.0)
    d = d + rng.normal(0, 0.01, d.shape)
    d[rng.random(d.shape) < holes] = 0.0
    return d.astype(np.float32)


def _pose(seed):
    rng = np.random.default_rng(seed)
    q = np.concatenate([[1.0], rng.normal(0, 0.05, 3)]).astype(np.float32)
    t = rng.normal(0, 0.1, 3).astype(np.float32)
    return np_(TG.pose_to_w2c(TG.normalize(torch.as_tensor(q)),
                              torch.as_tensor(t)))


def _both(fn_j, fn_t, *args):
    j = fn_j(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
               for a in args])
    t = fn_t(*[torch.as_tensor(a) if isinstance(a, np.ndarray) else a
               for a in args])
    return j, t


@pytest.mark.parametrize("seed", [0, 1])
def test_backproject_at_and_project_points(seed):
    d = _depth(seed)
    rng = np.random.default_rng(seed + 10)
    rows = rng.integers(0, H, 300)
    cols = rng.integers(0, W, 300)
    c2w = np.linalg.inv(_pose(seed)).astype(np.float32)
    j, t = _both(lambda *a: JG.backproject_at(*a[:4], c2w=a[4]),
                 lambda *a: TG.backproject_at(*a[:4], c2w=a[4]),
                 d, K, rows, cols, c2w)
    np.testing.assert_allclose(np_(t), np.asarray(j), rtol=1e-6, atol=1e-6)
    pts = np.asarray(j)
    (juv, jz), (tuv, tz) = _both(JG.project_points, TG.project_points, pts, K)
    np.testing.assert_allclose(np_(tz), np.asarray(jz), rtol=1e-6)
    np.testing.assert_allclose(np_(tuv), np.asarray(juv), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_depth_to_normals(seed):
    j, t = _both(JG.depth_to_normals, TG.depth_to_normals, _depth(seed), K)
    assert tuple(t.shape) == (H, W, 3)
    np.testing.assert_allclose(np_(t), np.asarray(j), atol=1e-5)


def _near(values, thresholds, tol):
    return np.abs(values - thresholds) <= tol


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("edge", [0.0, 5.0])
def test_frustum_mask(seed, edge):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, 2000), rng.uniform(-1.5, 1.5, 2000),
                    rng.uniform(-0.5, 4, 2000)], 1).astype(np.float32)
    w2c = _pose(seed)
    j, t = _both(lambda *a: JG.frustum_mask(*a, edge=edge),
                 lambda *a: TG.frustum_mask(*a, edge=edge), w2c, K, pts, H, W)
    j, t = np.asarray(j), np_(t)
    proj = (pts @ w2c[:3, :3].T + w2c[:3, 3]) @ K.T
    uv = proj[:, :2] / (proj[:, 2:] + 1e-8)
    near = (_near(uv[:, 0], edge, 1e-4) | _near(uv[:, 0], W - edge, 1e-4)
            | _near(uv[:, 1], edge, 1e-4) | _near(uv[:, 1], H - edge, 1e-4))
    assert (j == t)[~near].all()
    assert 0.1 < j.mean() < 0.9


@pytest.mark.parametrize("seed", [0, 1])
def test_bilinear_sample(seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 3, (H, W)).astype(np.float32)
    uv = np.stack([rng.uniform(-2, W + 1, 3000), rng.uniform(-2, H + 1, 3000)],
                  1).astype(np.float32)
    uv[:10] = np.round(uv[:10])                   # on the grid
    uv[10:20, 0] = W - 1                          # on the last column
    j, t = _both(JG.bilinear_sample, TG.bilinear_sample, img, uv)
    np.testing.assert_allclose(np_(t), np.asarray(j), rtol=1e-6, atol=1e-6)
    assert (np_(t)[(uv[:, 0] < -1) | (uv[:, 1] < -1)] == 0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_visibility_mask(seed):
    d_cur, d_ovl = _depth(seed), _depth(seed + 5, holes=0.05)
    cur_w2c, ovl_w2c = _pose(seed), _pose(seed + 7)
    pts = np_(TG.backproject(torch.as_tensor(d_cur), torch.as_tensor(K),
                             c2w=torch.as_tensor(np.linalg.inv(cur_w2c)
                                                 .astype(np.float32)),
                             depth_factor=1.0, pixel_center=0.0))
    j, t = _both(JG.visibility_mask, TG.visibility_mask, pts, ovl_w2c, K,
                 d_ovl, 0.05)
    j, t = np.asarray(j), np_(t)
    uv, z = JG.project_points(jnp.asarray(pts @ ovl_w2c[:3, :3].T
                                          + ovl_w2c[:3, 3]), jnp.asarray(K))
    ds = np.asarray(JG.bilinear_sample(jnp.asarray(d_ovl), uv))
    z = np.asarray(z)
    near = np.abs(np.abs(ds - z) - 0.05 * np.minimum(ds, z)) <= 1e-5 * z
    assert (j == t)[~near].all()
    assert 0.05 < j.mean() < 0.95


def _sections(seed, sizes, caps):
    """JAX sections and their bit-identical torch copies."""
    rng = np.random.default_rng(seed)
    out_j, out_t = [], []
    for k, (n, cap) in enumerate(zip(sizes, caps)):
        pts = rng.normal(0, 1, (cap, 3)).astype(np.float32)
        cols = rng.uniform(0, 1, (cap, 3)).astype(np.float32)
        msq = rng.uniform(1e-4, 1e-2, cap).astype(np.float32)
        js = JGS.init_section(jnp.asarray(pts), jnp.asarray(cols),
                              jnp.asarray(msq), n, cap, float(k), 1.0 + k)
        tt = lambda x: torch.as_tensor(np.array(x))
        p, v = js.params, js.vars
        out_j.append(js)
        out_t.append(TGS.Section(
            params=TGS.GaussianParams(*[tt(x) for x in (
                p.means3d, p.rgb_colors, p.unnorm_rotations,
                p.logit_opacities, p.log_scales)]),
            vars=TGS.GaussianVars(tt(v.max_2d_radius),
                                  tt(v.means2d_grad_accum), tt(v.denom),
                                  tt(v.timestep), float(v.scene_radius)),
            n_active=n))
    return out_j, out_t


def _fields(sec):
    p, v = sec.params, sec.vars
    return [np_(x) for x in (p.means3d, p.rgb_colors, p.unnorm_rotations,
                             p.logit_opacities, p.log_scales, v.max_2d_radius,
                             v.means2d_grad_accum, v.denom, v.timestep)]


@pytest.mark.parametrize("sizes, caps", [([300, 250], [512, 512]),
                                         ([300, 300], [512, 512]),
                                         ([100, 0, 450], [256, 128, 512])])
def test_concat_and_split_sections(sizes, caps):
    js, ts = _sections(sum(sizes), sizes, caps)
    jf, jsz = JGS.concat_sections(js, quantum=256)
    tf, tsz = TGS.concat_sections(ts, quantum=256)
    assert tsz == jsz == sizes
    assert tf.n_active == int(jf.n_active) == sum(sizes)
    assert tf.capacity == jf.capacity == JGS.round_capacity(sum(sizes), 256)
    assert tf.vars.scene_radius == float(jf.vars.scene_radius)
    for a, b in zip(_fields(tf), _fields(jf)):
        np.testing.assert_array_equal(a, b)
    # the fused buffer moves (trained fields), then splits back
    moved_t = tf.replace(params=tf.params.replace(
        rgb_colors=tf.params.rgb_colors + 1.0))
    moved_j = jf.replace(params=jf.params.replace(
        rgb_colors=jf.params.rgb_colors + 1.0))
    for a, b, orig in zip(TGS.split_section(moved_t, tsz, ts),
                          JGS.split_section(moved_j, jsz, js), ts):
        assert a.capacity == orig.capacity and a.n_active == orig.n_active
        for x, y in zip(_fields(a), _fields(b)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("masked", [False, True])
def test_base_frame_pointcloud(masked):
    rng = np.random.default_rng(3)
    d = _depth(3)[None]
    color = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    w2c = _pose(4)
    mask = rng.random((H, W)) < 0.6 if masked else None
    cam_kw = dict(height=H, width=W, fx=float(K[0, 0]), fy=float(K[1, 1]),
                  cx=float(K[0, 2]), cy=float(K[1, 2]))
    j = JD.base_frame_pointcloud(
        JFrame(color=jnp.asarray(color), depth=jnp.asarray(d)), JCam(**cam_kw),
        jnp.asarray(w2c), mask=None if mask is None else jnp.asarray(mask))
    t = TD.base_frame_pointcloud(
        TFrame(color=torch.as_tensor(color), depth=torch.as_tensor(d)),
        TCam(**cam_kw), torch.as_tensor(w2c),
        mask=None if mask is None else torch.as_tensor(mask))
    np.testing.assert_allclose(np_(t[0]), np.asarray(j[0]), rtol=1e-6,
                               atol=2e-6)
    np.testing.assert_array_equal(np_(t[1]), np.asarray(j[1]))
    np.testing.assert_allclose(np_(t[2]), np.asarray(j[2]), rtol=1e-6)
    np.testing.assert_array_equal(np_(t[3]), np.asarray(j[3]))
