"""The point-to-plane candidate metric (core/p2p.py) against the JAX package.

Inputs: two frames of the synthetic room (64 x 96, the JAX test_p2p.py
scene) and their ground-truth poses, with the source pose moved off by a
few seeded offsets. Checks:
  - the target's packed (H*W, 8) rows [point, normal, valid, 0]: points and
    valid flags within 1e-6 (f32 back-projection and one rigid transform),
    normals within 1e-5 (a cross product of central differences,
    normalized);
  - the metric for "sum", "max" and "max100" within 1e-4 relative (sums of
    up to 6144 squared f32 residuals in another order);
  - no surviving pair (the source camera turned away, or a NaN pose):
    +inf on both sides, for every method."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import first_exp_spent, np_  # noqa: F401
from vtgaussian_slam_tpu.core import p2p as JP2P
from vtgaussian_slam_tpu.datasets.synthetic import SyntheticRoomDataset
from vtgaussian_slam_tpu.ops import geometry as JG
from vtgaussian_slam_tpu_torch.core import p2p as TP2P
from vtgaussian_slam_tpu_torch.ops import geometry as TG

METHODS = ("sum", "max", "max100")


@pytest.fixture(scope="module")
def frames():
    ds = SyntheticRoomDataset(num_frames=20, height=64, width=96, seed=3,
                              motion_scale=0.3)
    _, d0, K, p0 = ds[0]
    _, d1, _, p1 = ds[1]
    K3 = np.asarray(K[:3, :3], np.float32)
    w2c0 = np.linalg.inv(np.asarray(p0, np.float64)).astype(np.float32)
    w2c1 = np.linalg.inv(np.asarray(p1, np.float64)).astype(np.float32)
    return d0[..., 0].astype(np.float32), d1[..., 0].astype(np.float32), \
        K3, w2c0, w2c1


def _targets(d, K, w2c):
    j = JP2P.make_p2p_target(jnp.asarray(d), jnp.asarray(K), jnp.asarray(w2c))
    t = TP2P.make_p2p_target(torch.as_tensor(d), torch.as_tensor(K),
                             torch.as_tensor(w2c))
    return j, t


def test_target_rows_match(frames):
    d0, _, K, w2c0, _ = frames
    j, t = _targets(d0, K, w2c0)
    a, b = np_(t.packed), np.asarray(j.packed)
    assert a.shape == b.shape == (d0.size, 8)
    np.testing.assert_allclose(a[:, :3], b[:, :3], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(a[:, 3:6], b[:, 3:6], atol=1e-5)
    np.testing.assert_array_equal(a[:, 6:], b[:, 6:])
    assert 0 < a[:, 6].mean() <= 1


def _offset(w2c, seed):
    if seed == 0:
        return w2c
    rng = np.random.default_rng(seed)
    q = np.concatenate([[1.0], rng.normal(0, 0.01, 3)]).astype(np.float32)
    dt = rng.normal(0, 0.01, 3).astype(np.float32)
    off = np_(TG.pose_to_w2c(TG.normalize(torch.as_tensor(q)),
                             torch.as_tensor(dt)))
    return (off @ w2c).astype(np.float32)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metric_matches(frames, method, seed):
    d0, d1, K, w2c0, w2c1 = frames
    j, t = _targets(d0, K, w2c0)
    src = _offset(w2c1, seed)
    mj = float(JP2P.point2plane_metric(j, jnp.asarray(d1), jnp.asarray(K),
                                       jnp.asarray(src), method=method))
    mt = float(TP2P.point2plane_metric(t, torch.as_tensor(d1),
                                       torch.as_tensor(K),
                                       torch.as_tensor(src), method=method))
    assert np.isfinite(mj) and mj > 0
    assert mt == pytest.approx(mj, rel=1e-4)


@pytest.mark.parametrize("method", METHODS)
def test_no_pairs_score_infinite(frames, method):
    d0, d1, K, w2c0, _ = frames
    j, t = _targets(d0, K, w2c0)
    flip = np_(TG.pose_to_w2c(torch.tensor([0.0, 0.0, 1.0, 0.0]),
                              torch.tensor([50.0, 0.0, 0.0])))
    nan_pose = np.full((4, 4), np.nan, np.float32)
    for pose in (flip, nan_pose):
        mj = float(JP2P.point2plane_metric(j, jnp.asarray(d1), jnp.asarray(K),
                                           jnp.asarray(pose), method=method))
        mt = float(TP2P.point2plane_metric(t, torch.as_tensor(d1),
                                           torch.as_tensor(K),
                                           torch.as_tensor(pose),
                                           method=method))
        assert mj == mt == float("inf")
    # and the flip is the JAX test's own: the JAX geometry agrees on it
    np.testing.assert_allclose(
        flip, np.asarray(JG.pose_to_w2c(jnp.array([0.0, 0.0, 1.0, 0.0]),
                                        jnp.array([50.0, 0.0, 0.0]))))
