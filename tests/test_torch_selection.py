"""Overlap selection (core/selection.py) and the base-frame pool
(pipeline.BaseframeStore) against the JAX package.

- `overlap_percents` over four candidate views of a wavy depth field
  (test_selection.py's scene): sampled mode with the JAX ranks injected,
  and vis mode over all pixels against a depth pool subsampled by stride 4
  and by 1. Scores are counts over the same pixels divided by the same
  count, so they agree to one pixel's share;
- the four host selectors on seeded percent arrays: equal outputs;
- `BaseframeStore`: the strided depths, poses and `rung()` as entries
  arrive, exactly, and the pool's w2c stack within 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import first_exp_spent, np_  # noqa: F401
from vtgaussian_slam_tpu.core import pipeline as JPL
from vtgaussian_slam_tpu.core import selection as JS
from vtgaussian_slam_tpu.ops import geometry as JG
from vtgaussian_slam_tpu_torch.core import pipeline as TPL
from vtgaussian_slam_tpu_torch.core import selection as TS
from vtgaussian_slam_tpu_torch.ops import geometry as TG

H, W = 48, 64
K = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32)


def _views(seed=0):
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    depth = (2.0 + 0.3 * np.sin(xx / 7.0) + 0.2 * np.cos(yy / 5.0)).astype(
        np.float32)
    rng = np.random.default_rng(seed)
    depth[rng.random((H, W)) < 0.1] = 0.0           # holes: invalid pixels
    offsets = [0.0, 0.3, 0.8, 2.0]
    w2cs = np.stack([np_(TG.pose_to_w2c(
        TG.normalize(torch.tensor([1.0, 0.02 * i, -0.01 * i, 0.0])),
        torch.tensor([dx, 0.05 * i, 0.0]))) for i, dx in enumerate(offsets)])
    depths = np.stack([np.roll(depth, i, 1) for i in range(len(offsets))])
    cur = np_(TG.pose_to_w2c(TG.normalize(torch.tensor([1.0, 0.0, 0.01, 0.0])),
                             torch.tensor([0.01, 0.0, 0.02])))
    return depth, cur, w2cs, depths


def test_overlap_percents_sampled_matches_with_injected_ranks():
    depth, cur, w2cs, depths = _views()
    key = jax.random.PRNGKey(3)
    n_valid = int((depth > 0).sum())
    ranks = np.asarray(jax.random.randint(key, (1600,), 0, n_valid))
    j = np.asarray(JS.overlap_percents(
        jnp.asarray(depth), jnp.asarray(cur), jnp.asarray(K),
        jnp.asarray(w2cs), jnp.asarray(depths), key, pixels=1600, edge=8))
    t = np_(TS.overlap_percents(
        torch.as_tensor(depth), torch.as_tensor(cur), torch.as_tensor(K),
        torch.as_tensor(w2cs), torch.as_tensor(depths), ranks=ranks,
        pixels=1600, edge=8))
    np.testing.assert_allclose(t, j, rtol=0, atol=1.0 / 1600 + 1e-7)
    assert j[0] > j[-1] and j[0] > 0.2
    # without injected ranks the port draws its own from the generator
    g = torch.Generator().manual_seed(0)
    own = np_(TS.overlap_percents(
        torch.as_tensor(depth), torch.as_tensor(cur), torch.as_tensor(K),
        torch.as_tensor(w2cs), torch.as_tensor(depths), pixels=1600, edge=8,
        generator=g))
    np.testing.assert_allclose(own, j, atol=0.06)    # sampling noise


@pytest.mark.parametrize("stride", [4, 1])
def test_overlap_percents_vis_mode_matches(stride):
    depth, cur, w2cs, depths = _views(1)
    pool = depths[:, ::stride, ::stride]
    j = np.asarray(JS.overlap_percents(
        jnp.asarray(depth), jnp.asarray(cur), jnp.asarray(K),
        jnp.asarray(w2cs), jnp.asarray(pool), jax.random.PRNGKey(0),
        pixels=0, edge=2, use_vis=True, kf_depth_thresh=0.05,
        depth_stride=stride))
    t = np_(TS.overlap_percents(
        torch.as_tensor(depth), torch.as_tensor(cur), torch.as_tensor(K),
        torch.as_tensor(w2cs), torch.as_tensor(pool), pixels=0, edge=2,
        use_vis=True, kf_depth_thresh=0.05, depth_stride=stride))
    n_valid = int((depth > 0).sum())
    np.testing.assert_allclose(t, j, rtol=0, atol=1.0 / n_valid + 1e-7)
    assert j.max() > 0.3


def _percents(seed, n):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, 1, n) ** 2
    p[rng.random(n) < 0.2] = 0.0
    return p.astype(np.float32)


@pytest.mark.parametrize("seed", range(6))
def test_host_selectors_match(seed):
    p = _percents(seed, 4 + 5 * seed)
    assert TS.select_topk_overlap(p, 1 + seed % 3) == \
        JS.select_topk_overlap(p, 1 + seed % 3)
    assert TS.select_visbased(p, 1 + seed % 2, 0.3) == \
        JS.select_visbased(p, 1 + seed % 2, 0.3)
    cfg = {"baseframe_every": 30, "overlap_every": 5 if seed % 2 else 10}
    for topk in (None, 3):
        assert TS.select_earliest_topk_base(p, cfg, 0.5, 0.8, topk) == \
            JS.select_earliest_topk_base(p, cfg, 0.5, 0.8, topk)
    # a correspondence chain over sections of 40 frames
    corr = [[max(0, 40 * (i - 1 - (i + seed) % 2)), None, 40 * i]
            for i in range(1, 2 + len(p) // 4)]
    scores = {i: float(v) for i, v in enumerate(_percents(seed + 50, 40))}
    for thres in (0.1, 0.5):
        assert TS.find_earliest_keyframe(corr, scores.get, 40, thres) == \
            JS.find_earliest_keyframe(corr, scores.get, 40, thres)


def test_baseframe_store_matches():
    Hs, Ws = 30, 41                     # not multiples of the stride
    jst = JPL.BaseframeStore(Hs, Ws, quantum=4, stride=4)
    tst = TPL.BaseframeStore(Hs, Ws, quantum=4, stride=4, device="cpu")
    rng = np.random.default_rng(7)
    rungs = []
    for i in range(11):
        d = rng.uniform(0.5, 3.0, (Hs, Ws)).astype(np.float32)
        q = np.concatenate([[1.0], rng.normal(0, 0.1, 3)]).astype(np.float32)
        t = rng.normal(0, 0.5, 3).astype(np.float32)
        jst.append(5 * i, jnp.asarray(d), jnp.asarray(q), jnp.asarray(t))
        tst.append(5 * i, torch.as_tensor(d), torch.as_tensor(q),
                   torch.as_tensor(t))
        assert tst.rung() == jst.rung()
        rungs.append(tst.rung())
    assert rungs[0] == 4 and rungs[-1] == 12     # min(max(8, pow2), rows)
    assert tst.ids == jst.ids and len(tst) == len(jst) == 11
    assert tuple(tst.depths.shape) == tuple(jst.depths.shape) == (12, 8, 11)
    np.testing.assert_array_equal(np_(tst.depths), np.asarray(jst.depths))
    np.testing.assert_array_equal(np_(tst.quats), np.asarray(jst.quats))
    np.testing.assert_array_equal(np_(tst.trans), np.asarray(jst.trans))
    r = tst.rung()
    np.testing.assert_allclose(np_(tst.w2cs(r)), np.asarray(jst.w2cs(r)),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(jst.w2cs(r))[0], np.asarray(
        JG.pose_to_w2c(JG.normalize(jst.quats[0]), jst.trans[0])), atol=1e-7)
