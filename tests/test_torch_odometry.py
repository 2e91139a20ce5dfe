"""The port's RGB-D visual odometry and multiavg pose propagation against
the JAX package's, on tests/test_odometry.py's synthetic frames.

Tolerances: the relative pose within 1e-4 of the JAX function's in both
methods (each 6x6 Gauss-Newton system is solved in float32, and
`torch.linalg.solve` and `jnp.linalg.solve` round differently; 30 steps
carry it) and within tests/test_odometry.py's bounds of the ground truth;
the identity within 5e-4 for the same frame; constant_velocity_init_multiavg
and the engine's pose propagation (constant velocity, and with multiavg
the two-motion average from frame 4 on) within 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import one_thread  # noqa: F401
from vtgaussian_slam_tpu.core.odometry import VisualOdometer as JOdo
from vtgaussian_slam_tpu.datasets.synthetic import SyntheticRoomDataset
from vtgaussian_slam_tpu.ops import geometry as JG
from vtgaussian_slam_tpu_torch.core.odometry import VisualOdometer as TOdo
from vtgaussian_slam_tpu_torch.ops import geometry as TG


@pytest.mark.parametrize("method", ["point_to_plane", "hybrid"])
def test_odometry_matches_jax_and_recovers_the_pose(method):
    ds = SyntheticRoomDataset(num_frames=30, height=96, width=128, seed=2,
                              motion_scale=0.3)
    c0, d0, K, p0 = ds[0]
    c1, d1, _, p1 = ds[1]
    j = JOdo(K[:3, :3], method_name=method)
    t = TOdo(K[:3, :3], method_name=method, device="cpu")
    j.update_last_rgbd(c0, d0)
    t.update_last_rgbd(c0, d0)
    rj = j.estimate_rel_pose(c1, d1)
    rt = t.estimate_rel_pose(c1, d1)
    np.testing.assert_allclose(rt, rj, atol=1e-4, rtol=0)

    rel_gt = np.linalg.inv(np.asarray(p0, np.float64)) @ np.asarray(
        p1, np.float64)
    t_err = np.linalg.norm(rt[:3, 3] - rel_gt[:3, 3])
    motion = np.linalg.norm(rel_gt[:3, 3])
    limit = 0.25 * motion if method == "hybrid" else 0.6 * motion
    assert t_err < max(limit, 0.005), (t_err, motion)
    dR = rt[:3, :3].T @ rel_gt[:3, :3]
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    assert ang < 0.5, ang


def test_odometry_identity_for_same_frame():
    ds = SyntheticRoomDataset(num_frames=2, height=64, width=96, seed=0)
    c0, d0, K, _ = ds[0]
    odo = TOdo(K[:3, :3], method_name="point_to_plane", device="cpu")
    odo.update_last_rgbd(c0, d0)
    # a depth tensor on the device is taken as it is
    rel = odo.estimate_rel_pose(c0, torch.as_tensor(d0[..., 0]))
    np.testing.assert_allclose(rel, np.eye(4), atol=5e-4)


def test_invalid_method_raises():
    with pytest.raises(ValueError):
        TOdo(np.eye(3), method_name="nope", device="cpu")


def test_multiavg_matches_jax():
    rng = np.random.default_rng(0)
    w2cs = []
    for i in range(3):
        q = np.array([1.0, 0, 0, 0]) + rng.normal(0, 0.05, 4)
        tr = rng.normal(0, 0.1, 3)
        w2cs.append(np.array(JG.pose_to_w2c(
            JG.normalize(jnp.asarray(q, jnp.float32)),
            jnp.asarray(tr, jnp.float32))))
    want = np.asarray(JG.constant_velocity_init_multiavg(
        *[jnp.asarray(w) for w in w2cs]))
    got = TG.constant_velocity_init_multiavg(
        *[torch.as_tensor(w) for w in w2cs]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # the elementwise average is not rigid: the general inverse differs
    # from the transpose-based one
    single = TG.constant_velocity_init(torch.as_tensor(w2cs[0]),
                                       torch.as_tensor(w2cs[1])).numpy()
    assert np.abs(got - single).max() > 1e-4


@pytest.mark.parametrize("multiavg", [False, True])
def test_engine_pose_propagation_matches_jax(multiavg):
    """The engine's pose init from a trajectory: constant velocity up to
    frame 3, the two-motion average from frame 4 on with multiavg."""
    from types import SimpleNamespace

    from vtgaussian_slam_tpu.core.pipeline import _propagate_pose
    from vtgaussian_slam_tpu_torch.core.pipeline import VTGaussianSLAM
    from vtgaussian_slam_tpu_torch.models.gaussians import CameraTrajectory
    rng = np.random.default_rng(1)
    q = (np.array([1.0, 0, 0, 0]) + rng.normal(0, 0.03, (8, 4))).astype(
        np.float32)
    tr = rng.normal(0, 0.05, (8, 3)).astype(np.float32)
    eng = SimpleNamespace(
        traj=CameraTrajectory(quats=torch.as_tensor(q),
                              trans=torch.as_tensor(tr)),
        config={"tracking": {"multiavg": multiavg}})
    for t in range(1, 8):
        jq, jt = _propagate_pose(jnp.asarray(q), jnp.asarray(tr), t,
                                 multiavg=multiavg)
        tq, tt = VTGaussianSLAM._propagate_pose(eng, t)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6,
                                   rtol=0)
