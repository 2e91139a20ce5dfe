"""PyTorch port vs the JAX package: geometry, sections, Adam."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import np_, scene_np
from vtgaussian_slam_tpu.models import gaussians as JG
from vtgaussian_slam_tpu.models import optimizer as JO
from vtgaussian_slam_tpu.ops import geometry as jgeo
from vtgaussian_slam_tpu_torch.models import gaussians as TG
from vtgaussian_slam_tpu_torch.models import optimizer as TO
from vtgaussian_slam_tpu_torch.ops import geometry as tgeo

# f32 elementwise math in a different operation order: a few ulps
RTOL, ATOL = 1e-6, 1e-6


def _quats(n, seed):
    return np.random.default_rng(seed).standard_normal((n, 4)).astype(np.float32)


@pytest.mark.parametrize("fn", ["normalize", "quat_to_rotmat", "quat_mult",
                                "rotmat_to_quat"])
def test_quaternion_ops(fn):
    q1, q2 = _quats(32, 0), _quats(32, 1)
    if fn == "quat_mult":
        ref = jgeo.quat_mult(jnp.asarray(q1), jnp.asarray(q2))
        got = tgeo.quat_mult(torch.as_tensor(q1), torch.as_tensor(q2))
    elif fn == "rotmat_to_quat":
        m = np.array(jgeo.quat_to_rotmat(jnp.asarray(q1)))
        ref = jgeo.rotmat_to_quat(jnp.asarray(m))
        got = tgeo.rotmat_to_quat(torch.as_tensor(m))
    else:
        ref = getattr(jgeo, fn)(jnp.asarray(q1))
        got = getattr(tgeo, fn)(torch.as_tensor(q1))
    np.testing.assert_allclose(np_(got), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_se3_ops():
    q, t = _quats(8, 2), np.random.default_rng(3).standard_normal((8, 3)).astype(
        np.float32)
    ref_w2c = jgeo.pose_to_w2c(jnp.asarray(q), jnp.asarray(t))
    got_w2c = tgeo.pose_to_w2c(torch.as_tensor(q), torch.as_tensor(t))
    np.testing.assert_allclose(np_(got_w2c), np.asarray(ref_w2c), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(np_(tgeo.invert_se3(got_w2c)),
                               np.asarray(jgeo.invert_se3(ref_w2c)),
                               rtol=RTOL, atol=ATOL)
    rq, rt = jgeo.w2c_to_pose(ref_w2c)
    gq, gt = tgeo.w2c_to_pose(got_w2c)
    np.testing.assert_allclose(np_(gq), np.asarray(rq), rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(np_(gt), np.asarray(rt), rtol=RTOL, atol=ATOL)
    pts = np.random.default_rng(4).standard_normal((50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np_(tgeo.transform_points(got_w2c[0], torch.as_tensor(pts))),
        np.asarray(jgeo.transform_points(ref_w2c[0], jnp.asarray(pts))),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        np_(tgeo.constant_velocity_init(got_w2c[0], got_w2c[1])),
        np.asarray(jgeo.constant_velocity_init(ref_w2c[0], ref_w2c[1])),
        rtol=1e-5, atol=1e-5)


def test_backproject_and_scale():
    rng = np.random.default_rng(5)
    depth = rng.uniform(0.5, 4.0, (40, 48)).astype(np.float32)
    depth[3:7, 10:12] = 0.0
    K = np.array([[48.0, 0, 24.0], [0, 48.0, 20.0], [0, 0, 1]], np.float32)
    c2w = np.asarray(jgeo.pose_to_w2c(jnp.asarray(_quats(1, 6)[0]),
                                      jnp.asarray([0.1, -0.2, 0.3])))
    ref = jgeo.backproject(jnp.asarray(depth), jnp.asarray(K), jnp.asarray(c2w))
    got = tgeo.backproject(torch.as_tensor(depth), torch.as_tensor(K),
                           torch.as_tensor(c2w))
    np.testing.assert_allclose(np_(got), np.asarray(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        np_(tgeo.mean_sq_dist_projective(torch.as_tensor(depth).reshape(-1),
                                         48.0, 48.0)),
        np.asarray(jgeo.mean_sq_dist_projective(jnp.asarray(depth).reshape(-1),
                                                48.0, 48.0)), rtol=RTOL)


@pytest.mark.parametrize("n", [1, 32768, 32769, 1_000_000])
def test_round_capacity_ladder(n):
    assert TG.round_capacity(n, 32768) == JG.round_capacity(n, 32768)


def _cloud(m, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, 3)).astype(np.float32),
            rng.uniform(0, 1, (m, 3)).astype(np.float32),
            rng.uniform(1e-4, 1e-2, m).astype(np.float32))


def _assert_section_equal(got, ref):
    assert got.n_active == int(ref.n_active)
    for a in ("means3d", "rgb_colors", "unnorm_rotations", "logit_opacities",
              "log_scales"):
        np.testing.assert_allclose(np_(getattr(got.params, a)),
                                   np.asarray(getattr(ref.params, a)),
                                   rtol=RTOL, atol=ATOL, err_msg=a)
    np.testing.assert_array_equal(np_(got.vars.timestep),
                                  np.asarray(ref.vars.timestep))


def test_init_and_append_match_jax():
    pts, cols, msq = _cloud(100, 7)
    ref = JG.init_section(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(msq),
                          80, 128, 0.0, 1.5)
    got = TG.init_section(torch.as_tensor(pts), torch.as_tensor(cols),
                          torch.as_tensor(msq), 80, 128, 0.0, 1.5)
    _assert_section_equal(got, ref)
    npts, ncols, nmsq = _cloud(30, 8)
    keep = np.random.default_rng(9).uniform(size=30) > 0.4
    ref = JG.append_gaussians(ref, jnp.asarray(npts), jnp.asarray(ncols),
                              jnp.asarray(nmsq), jnp.asarray(keep), 3.0)
    got = TG.append_gaussians(got, torch.as_tensor(npts), torch.as_tensor(ncols),
                              torch.as_tensor(nmsq), torch.as_tensor(keep), 3.0)
    _assert_section_equal(got, ref)
    grown = TG.repad_section(got, 256)
    assert grown.capacity == 256 and grown.n_active == got.n_active
    np.testing.assert_array_equal(np_(grown.params.means3d[:128]),
                                  np_(got.params.means3d))


def test_numpy_params_round_trip():
    p = scene_np(300, 1)
    sec_j, traj_j = JG.section_from_numpy_params(p, quantum=128)
    exported = JG.section_to_numpy_params(sec_j, traj_j)
    sec, traj = TG.section_from_numpy_params(exported, quantum=128,
                                             device="cpu")
    assert sec.n_active == 300 and sec.capacity == int(sec_j.capacity)
    back = TG.section_to_numpy_params(sec, traj)
    for k, v in exported.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_adam_matches_jax():
    rng = np.random.default_rng(10)
    params = [rng.standard_normal((20, 8)).astype(np.float32),
              rng.standard_normal((7,)).astype(np.float32)]
    lrs = [0.01, 0.0]
    jp = [jnp.asarray(x) for x in params]
    js = JO.adam_init(jp)
    tp = [torch.as_tensor(x) for x in params]
    ts = TO.adam_init(tp)
    for step in range(5):
        grads = [rng.standard_normal(x.shape).astype(np.float32)
                 for x in params]
        jp, js = JO.adam_step(jp, [jnp.asarray(g) for g in grads], js, lrs,
                              eps=1e-15)
        tp, ts = TO.adam_step(tp, [torch.as_tensor(g) for g in grads], ts, lrs,
                              eps=1e-15)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-5, atol=1e-6)
    # zero-lr leaves keep their values but still update their moments
    np.testing.assert_array_equal(np_(tp[1]), params[1])
    np.testing.assert_allclose(np_(ts.nu[1]), np.asarray(js.nu[1]), rtol=1e-6)
    assert ts.count == int(js.count) == 5


def test_relative_transformation_matches_jax():
    """Batched (2, 3, 4, 4) poses, and one against a batch (broadcast)."""
    q = _quats(12, 5)
    t = np.random.default_rng(6).standard_normal((12, 3)).astype(np.float32)
    T = np.array(jgeo.pose_to_w2c(jgeo.normalize(jnp.asarray(q)),
                                  jnp.asarray(t))).reshape(2, 2, 3, 4, 4)
    for a, b in ((T[0], T[1]), (T[0, 0, 0], T[1])):
        np.testing.assert_allclose(
            np_(tgeo.relative_transformation(torch.as_tensor(a),
                                             torch.as_tensor(b))),
            np.asarray(jgeo.relative_transformation(jnp.asarray(a),
                                                    jnp.asarray(b))),
            rtol=RTOL, atol=ATOL)
