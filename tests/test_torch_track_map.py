"""PyTorch port vs the JAX package: one tracking phase, one mapping phase
and one densification step, from the same map and frames.

Tracking: 8 iterations of the cached-binning loop from the same init pose
must give the same per-iteration loss curve and best pose. Mapping: 8
iterations with the JAX engine's keyframe draws injected must give the same
field table. Both loops feed Adam, which normalises each gradient entry, so
the kernels' ~1e-4 relative differences show up at ~1e-4 in the losses and
as ~lr * 1e-3 in the parameters; tolerances below say so per check."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (H, POSE_Q, POSE_T, W, jax_cam, jax_params, np_,
                             scene_np, torch_cam, torch_params)
from vtgaussian_slam_tpu.core import densify as JD
from vtgaussian_slam_tpu.core import losses as JL
from vtgaussian_slam_tpu.core import map_cache as JMC
from vtgaussian_slam_tpu.core import mapping as JMP
from vtgaussian_slam_tpu.core import tracking as JT
from vtgaussian_slam_tpu.core.p2p import make_p2p_target
from vtgaussian_slam_tpu.core.track_cache import build_track_cache as j_btc
from vtgaussian_slam_tpu_torch.core import densify as TD
from vtgaussian_slam_tpu_torch.core import losses as TL
from vtgaussian_slam_tpu_torch.core import map_cache as TMC
from vtgaussian_slam_tpu_torch.core import mapping as TMP
from vtgaussian_slam_tpu_torch.core import tracking as TT
from vtgaussian_slam_tpu_torch.core.track_cache import build_track_cache as t_btc

BK = {"span_cap": 3, "max_pairs_per_tile": 256, "chunk": 128}
JBK = dict(BK, use_pallas=True)     # the JAX renderer's Pallas route
N = 700


def _target_frames(poses, seed=20, p=None):
    """Ground-truth frames: renders of a scene (a denser one by default) at
    the given poses."""
    if p is None:
        p = scene_np(1500, seed, logit_lo=1.0, logit_hi=4.0)
    n = p["means3D"].shape[0]
    out = []
    for q, t in poses:
        r = JL.render_slam(jax_params(p), jnp.ones(n, bool), jnp.asarray(q),
                           jnp.asarray(t), jax_cam(), JBK)
        out.append((np.asarray(r.im), np.maximum(np.asarray(r.depth), 0.1)))
    return out


def _lcfg(mod, tracking):
    if tracking:
        return mod.LossConfig(tracking=True, use_sil_for_loss=True,
                              ignore_outlier_depth_loss=False, adaptive_sil=True,
                              im_weight=0.5, depth_weight=0.025)
    return mod.LossConfig(tracking=False, use_sil_for_loss=False,
                          ignore_outlier_depth_loss=False, adaptive_sil=False,
                          im_weight=1.0, depth_weight=1.0)


def test_tracking_phase_matches_jax():
    p = scene_np(N, 21, logit_lo=1.0, logit_hi=4.0)
    (color, depth), = _target_frames([(POSE_Q, POSE_T)], p=p)
    q0 = (POSE_Q + np.array([0.0, 0.004, -0.003, 0.002], np.float32))
    t0 = POSE_T + np.array([0.01, -0.008, 0.012], np.float32)
    iters = 8
    jcache = j_btc(jax_params(p), jnp.ones(N, bool), jnp.asarray(q0),
                   jnp.asarray(t0), jax_cam(), span_cap=3,
                   max_pairs_per_tile=256, chunk=128, select="importance")
    jcfg = JT.TrackingConfig(num_iters=iters, lr_quat=0.0004, lr_trans=0.002,
                             metric="loss", p2p_method="sum",
                             loss_cfg=_lcfg(JL, True))
    dummy = make_p2p_target(jnp.zeros((1, 8, 8)), jnp.eye(3), jnp.eye(4))
    js, j_im, j_d = JT.track_frame_cached(
        jcache, JT.init_track_state(jnp.asarray(q0), jnp.asarray(t0), 0.99),
        JL.Frame(color=jnp.asarray(color), depth=jnp.asarray(depth)),
        jnp.ones((H, W), bool), dummy, jax_cam(), jcfg)

    tcache = t_btc(torch_params(p), torch.ones(N, dtype=torch.bool),
                   torch.as_tensor(q0), torch.as_tensor(t0), torch_cam(),
                   span_cap=3, max_pairs_per_tile=256, select="importance")
    np.testing.assert_array_equal(np_(tcache.counts),
                                  np.asarray(jcache.counts)[:9])
    tcfg = TT.TrackingConfig(num_iters=iters, lr_quat=0.0004, lr_trans=0.002,
                             metric="loss", loss_cfg=_lcfg(TL, True))
    ts, t_im, t_d = TT.track_frame_cached(
        tcache, TT.init_track_state(torch.as_tensor(q0), torch.as_tensor(t0),
                                    0.99),
        TL.Frame(color=torch.as_tensor(color.copy()),
                 depth=torch.as_tensor(depth.copy())),
        None, torch_cam(), tcfg)
    # loss curves: kernel-level 1e-4 differences carried through Adam
    np.testing.assert_allclose(np_(t_im), np.asarray(j_im), rtol=1e-3)
    np.testing.assert_allclose(np_(t_d), np.asarray(j_d), rtol=1e-3)
    assert float(ts.sil_thres) == pytest.approx(float(js.sil_thres))
    # best pose: steps are lr-sized (4e-4 / 2e-3); 1e-5 is < 1% of a step
    np.testing.assert_allclose(np_(ts.best_quat), np.asarray(js.best_quat),
                               atol=1e-5)
    np.testing.assert_allclose(np_(ts.best_trans), np.asarray(js.best_trans),
                               atol=1e-5)
    # tracking moved the pose towards the target
    assert float(ts.min_loss) < float(t_im[0] * 0.5 + t_d[0] * 0.025)
    err0 = np.abs(t0 - POSE_T).sum()
    assert np.abs(np_(ts.best_trans) - POSE_T).sum() < err0


def test_mapping_phase_matches_jax_with_injected_draws():
    poses = [(np.array([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32)),
             (POSE_Q, POSE_T)]
    frames = _target_frames(poses, seed=22)
    p = scene_np(N, 23)
    iters = 8
    lrs = (("log_scales", 0.005), ("logit_opacities", 0.05), ("means3D", 0.0),
           ("rgb_colors", 0.0025), ("unnorm_rotations", 0.0))
    jp = jax_params(p)
    jstore = JMC.MapCacheStore(select="importance")
    tstore = TMC.MapCacheStore(select="importance")
    tp = torch_params(p)
    for ring, (q, t) in enumerate(poses):
        jstack, jslot_ids, count = jstore.update(
            jp, jnp.ones(N, bool), N, ring, jnp.asarray(q), jnp.asarray(t),
            jax_cam(), 2, 256, 4)
        tslots, tslot_ids, tcount = tstore.update(
            tp, torch.ones(N, dtype=torch.bool), N, ring, torch.as_tensor(q),
            torch.as_tensor(t), torch_cam(), 2, 256, 4)
    assert tcount == count == 2 and tslot_ids == [0, 1]
    colors = np.zeros((4, 3, H, W), np.float32)
    depths = np.zeros((4, 1, H, W), np.float32)
    for i, (c, d) in enumerate(frames):
        colors[i], depths[i] = c, d
    quats = np.stack([q for q, _ in poses] + [poses[0][0]] * 2)
    trans = np.stack([t for _, t in poses] + [poses[0][1]] * 2)
    jkf = JMP.KeyframeBuffer(colors=jnp.asarray(colors),
                             depths=jnp.asarray(depths), quats=jnp.asarray(quats),
                             trans=jnp.asarray(trans),
                             frame_ids=jnp.arange(4, dtype=jnp.int32) + 1,
                             count=jnp.asarray(count, jnp.int32))
    cfg = JMP.MappingConfig(num_iters=iters, lrs=lrs, loss_cfg=_lcfg(JL, False),
                            use_global=False, baseframe_every=40)
    rng = jax.random.PRNGKey(7)
    jparams, jhist = JMP.map_frame_binned(
        jp, jkf, jstack, jslot_ids, JMC.dummy_global_cache(jp), rng, jax_cam(),
        cfg)
    # the JAX loop's keyframe draws (mapping.py:242-243), injected
    draws = [int(jax.random.randint(jax.random.fold_in(rng, i), (), 0,
                                    jnp.asarray(count, jnp.int32)))
             for i in range(iters)]
    assert len(set(draws)) == 2
    tkf = TMP.KeyframeBuffer(colors=torch.as_tensor(colors),
                             depths=torch.as_tensor(depths), count=tcount)
    tcfg = TMP.MappingConfig(num_iters=iters, lrs=lrs,
                             loss_cfg=_lcfg(TL, False), use_global=False)
    tparams, thist = TMP.map_frame_binned(tp, tkf, tslots, tslot_ids,
                                          torch_cam(), tcfg, draws=draws)
    # [loss, im, depth] per iteration: kernel-level differences through Adam
    np.testing.assert_allclose(np_(thist), np.asarray(jhist), rtol=1e-3)
    f_t = np_(TMC.pack_fields8(tparams))
    f_j = np.asarray(JMC.pack_fields8(jparams))
    np.testing.assert_array_equal(f_t[:, :3], p["means3D"])
    # Adam moves each entry by <= lr per step; entries agree to 1e-3 * lr
    # scale except where a gradient is rounding noise (Adam normalises it
    # to a full step): 99% of entries within 5e-4 absolute
    diff = np.abs(f_t[:, 3:] - f_j[:, 3:])
    close = diff <= 5e-4 + 1e-3 * np.abs(f_j[:, 3:])
    assert close.mean() > 0.99, close.mean()
    # and every entry: no further apart than lr * iters, the most Adam
    # moves an entry in the loop (a wrong gradient on a few rows would
    # push them a full step per iteration away)
    lr = dict(lrs)
    reach = iters * np.array([lr["logit_opacities"], lr["log_scales"]]
                             + [lr["rgb_colors"]] * 3)
    assert (diff <= reach).all(), (diff / reach).max(0)
    moved = np.abs(f_j[:, 3:] - np.asarray(JMC.pack_fields8(jp))[:, 3:]) > 0
    assert moved.mean() > 0.3


def test_densify_matches_jax():
    (color, depth), = _target_frames([(POSE_Q, POSE_T)], seed=24)
    depth = depth.copy()
    depth[0, :6, :9] = 0.0
    p = scene_np(400, 25)
    npres_j = np.asarray(JD.densify_nonpresence(
        jax_params(p), jnp.ones(400, bool), jnp.asarray(POSE_Q),
        jnp.asarray(POSE_T), JL.Frame(color=jnp.asarray(color),
                                      depth=jnp.asarray(depth)),
        jax_cam(), 0.5, tuple(sorted(JBK.items()))))
    npres_t = np_(TD.densify_nonpresence(
        torch_params(p), torch.ones(400, dtype=torch.bool),
        torch.as_tensor(POSE_Q), torch.as_tensor(POSE_T),
        TL.Frame(color=torch.as_tensor(color.copy()), depth=torch.as_tensor(depth)),
        torch_cam(), 0.5, tuple(sorted(BK.items()))))
    np.testing.assert_array_equal(npres_t, npres_j)
    assert 0.05 < npres_j.mean() < 0.95
    d0 = depth[0]
    idx = np.flatnonzero(npres_j & (d0 > 0))
    cols = np.transpose(color, (1, 2, 0)).reshape(-1, 3)[idx]
    ref = JD.densify_from_pixels(
        jnp.asarray(POSE_Q), jnp.asarray(POSE_T),
        jnp.asarray(d0.reshape(-1)[idx]), jnp.asarray(cols),
        jnp.asarray(idx, jnp.int32), jnp.ones(len(idx), bool), jax_cam())
    got = TD.densify_from_pixels(
        torch.as_tensor(POSE_Q), torch.as_tensor(POSE_T),
        torch.as_tensor(d0.reshape(-1)[idx].copy()), torch.as_tensor(cols),
        torch.as_tensor(idx), torch.ones(len(idx), dtype=torch.bool),
        torch_cam())
    # f32 back-projection + rigid transform: a few ulps of ~3 m coordinates
    np.testing.assert_allclose(np_(got.points), np.asarray(ref.points),
                               rtol=1e-6, atol=2e-6)
    np.testing.assert_allclose(np_(got.mean3_sq_dist),
                               np.asarray(ref.mean3_sq_dist), rtol=1e-6)
    np.testing.assert_array_equal(np_(got.keep), np.asarray(ref.keep))
