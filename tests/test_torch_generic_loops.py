"""PyTorch port vs the JAX package: the generic tracking and mapping loops
(`track_frame`, `map_frame`), which render from scratch every iteration
(K4 forward, K5 backward, autograd through the projection).

Tracking: 6 iterations from the same perturbed pose must give the same
per-iteration loss curve and best pose. Mapping: 6 iterations with the JAX
loop's keyframe draws injected must give the same parameters, with the
lrs of every shipped config and with nonzero means / rotations lrs (the
configurations only this route serves), on (N, 1) and (N, 3) scales. Adam
normalises each gradient entry, so the ~1e-5 relative gradient differences
of test_torch_generic.py show up at ~1e-4 in the loss curves and as a
fraction of lr in the parameters; the tolerances below say so per check."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_track_map import _lcfg, _target_frames
from torch_port_util import (H, POSE_Q, POSE_T, W, jax_cam, jax_params, np_,
                             scene_np, torch_cam, torch_params)
from vtgaussian_slam_tpu.core import losses as JL
from vtgaussian_slam_tpu.core import mapping as JMP
from vtgaussian_slam_tpu.core import tracking as JT
from vtgaussian_slam_tpu.core.p2p import make_p2p_target
from vtgaussian_slam_tpu.models import gaussians as JG
from vtgaussian_slam_tpu_torch.core import losses as TL
from vtgaussian_slam_tpu_torch.core import mapping as TMP
from vtgaussian_slam_tpu_torch.core import tracking as TT
from vtgaussian_slam_tpu_torch.models.gaussians import PARAM_KEYS

BK = {"span_cap": 3, "max_pairs_per_tile": 256, "chunk": 128}
JBK = tuple(sorted(dict(BK, use_pallas=True).items()))
TBK = tuple(sorted(BK.items()))
N = 600
ITERS = 6


def test_track_frame_matches_jax():
    p = scene_np(N, 31, logit_lo=1.0, logit_hi=4.0)
    (color, depth), = _target_frames([(POSE_Q, POSE_T)], p=p)
    q0 = POSE_Q + np.array([0.0, 0.004, -0.003, 0.002], np.float32)
    t0 = POSE_T + np.array([0.01, -0.008, 0.012], np.float32)
    jcfg = JT.TrackingConfig(
        num_iters=ITERS, lr_quat=0.0004, lr_trans=0.002, metric="loss",
        p2p_method="sum", loss_cfg=_lcfg(JL, True)._replace(backend_kwargs=JBK))
    dummy = make_p2p_target(jnp.zeros((1, 8, 8)), jnp.eye(3), jnp.eye(4))
    js, j_im, j_d = JT.track_frame(
        jax_params(p), jnp.ones(N, bool),
        JT.init_track_state(jnp.asarray(q0), jnp.asarray(t0), 0.99),
        JL.Frame(color=jnp.asarray(color), depth=jnp.asarray(depth)),
        jnp.ones((H, W), bool), dummy, jax_cam(), jcfg)

    tcfg = TT.TrackingConfig(
        num_iters=ITERS, lr_quat=0.0004, lr_trans=0.002, metric="loss",
        loss_cfg=_lcfg(TL, True)._replace(backend_kwargs=TBK))
    ts, t_im, t_d = TT.track_frame(
        torch_params(p), torch.ones(N, dtype=torch.bool),
        TT.init_track_state(torch.as_tensor(q0), torch.as_tensor(t0), 0.99),
        TL.Frame(color=torch.as_tensor(color.copy()),
                 depth=torch.as_tensor(depth.copy())), None, torch_cam(), tcfg)
    # loss curves: gradient-level 1e-5 differences carried through Adam
    np.testing.assert_allclose(np_(t_im), np.asarray(j_im), rtol=1e-3)
    np.testing.assert_allclose(np_(t_d), np.asarray(j_d), rtol=1e-3)
    assert float(ts.sil_thres) == pytest.approx(float(js.sil_thres))
    # best pose: steps are lr-sized (4e-4 / 2e-3); 1e-5 is < 1% of a step
    np.testing.assert_allclose(np_(ts.best_quat), np.asarray(js.best_quat),
                               atol=1e-5)
    np.testing.assert_allclose(np_(ts.best_trans), np.asarray(js.best_trans),
                               atol=1e-5)
    assert np.abs(np_(ts.best_trans) - POSE_T).sum() < np.abs(t0 - POSE_T).sum()


LRS = {"log_scales": 0.005, "logit_opacities": 0.05, "means3D": 0.0,
       "rgb_colors": 0.0025, "unnorm_rotations": 0.0}


@pytest.mark.parametrize("lrs,aniso", [
    (LRS, False),
    (dict(LRS, means3D=0.0001, unnorm_rotations=0.001), True),
])
def test_map_frame_matches_jax_with_injected_draws(lrs, aniso):
    poses = [(np.array([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32)),
             (POSE_Q, POSE_T)]
    frames = _target_frames(poses, seed=32)
    p = scene_np(N, 33)
    if aniso:
        rng = np.random.default_rng(34)
        p["log_scales"] = np.repeat(p["log_scales"], 3, 1) + rng.uniform(
            -0.3, 0.3, (N, 3)).astype(np.float32)
        p["unnorm_rotations"] = rng.standard_normal((N, 4)).astype(np.float32)
    colors = np.zeros((3, 3, H, W), np.float32)
    depths = np.zeros((3, 1, H, W), np.float32)
    for i, (c, d) in enumerate(frames):
        colors[i], depths[i] = c, d
    quats = np.stack([q for q, _ in poses] + [poses[0][0]])
    trans = np.stack([t for _, t in poses] + [poses[0][1]])
    count = 2
    lr_items = tuple(sorted(lrs.items()))
    jcfg = JMP.MappingConfig(
        num_iters=ITERS, lrs=lr_items, use_global=False, baseframe_every=40,
        loss_cfg=_lcfg(JL, False)._replace(backend_kwargs=JBK))
    dummy = JG.init_section(jnp.zeros((1, 3)), jnp.zeros((1, 3)), jnp.ones((1,)),
                            0, 1, 0.0, 1.0, isotropic=not aniso)
    jkf = JMP.KeyframeBuffer(
        colors=jnp.asarray(colors), depths=jnp.asarray(depths),
        quats=jnp.asarray(quats), trans=jnp.asarray(trans),
        frame_ids=jnp.arange(3, dtype=jnp.int32),
        count=jnp.asarray(count, jnp.int32))
    rng = jax.random.PRNGKey(11)
    jparams, jhist = JMP.map_frame(jax_params(p), jnp.ones(N, bool),
                                   dummy.params, dummy.active_mask(), jkf, rng,
                                   jax_cam(), jcfg)
    # the JAX loop's keyframe draws (mapping.py:162-163), injected
    draws = [int(jax.random.randint(jax.random.fold_in(rng, i), (), 0,
                                    jnp.asarray(count, jnp.int32)))
             for i in range(ITERS)]
    assert len(set(draws)) == 2

    tkf = TMP.KeyframeBuffer(
        colors=torch.as_tensor(colors), depths=torch.as_tensor(depths),
        count=count, quats=torch.as_tensor(quats), trans=torch.as_tensor(trans))
    tcfg = TMP.MappingConfig(
        num_iters=ITERS, lrs=lr_items, use_global=False,
        loss_cfg=_lcfg(TL, False)._replace(backend_kwargs=TBK))
    tparams, thist = TMP.map_frame(torch_params(p),
                                   torch.ones(N, dtype=torch.bool), tkf,
                                   torch_cam(), tcfg, draws=draws)
    # [loss, im, depth] per iteration: gradient-level differences via Adam
    np.testing.assert_allclose(np_(thist), np.asarray(jhist), rtol=1e-3)
    for field, attr in PARAM_KEYS:
        a = np_(getattr(tparams, attr))
        b = np.asarray(getattr(jparams, attr))
        assert a.shape == b.shape, (attr, a.shape, b.shape)
        lr = lrs.get(field, 0.0)
        if lr == 0.0:
            # frozen leaves: bit-identical to the input
            np.testing.assert_array_equal(a, np.asarray(p[field]))
            continue
        # Adam moves an entry by <= lr per step; 99% agree to 1e-3 of a
        # full reach, and none is further apart than lr * iterations (a
        # wrong gradient would push its rows a full step per iteration)
        diff = np.abs(a - b)
        assert (diff <= 1e-3 * lr * ITERS + 1e-6 * np.abs(b)).mean() > 0.99, \
            (attr, diff.max() / (lr * ITERS))
        assert diff.max() <= lr * ITERS, (attr, diff.max() / (lr * ITERS))
        assert np.abs(b - np.asarray(p[field])).max() > 0.1 * lr, attr
