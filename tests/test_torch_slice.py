"""The first port slice end to end against the JAX engine.

Both engines run the same tiny replica-family synthetic proxy (40 x 48,
2x densification stream) for 3 frames with 4-iteration track / map budgets,
on their kernel routes (the JAX engine's Pallas kernels in interpret mode:
on the CPU it would otherwise take its generic XLA paths). The port gets the
JAX engine's mapping keyframe draws injected (`jax.random` and torch
generators give different streams). Both use the numpy Canny edge mask.

Tolerances: poses 2e-4 (a few Adam steps of lr 4e-4 / 2e-3 carrying the
kernels' ~1e-4 relative differences); Gaussian counts exact (the
densification masks are thresholds on renders that agree to ~1e-5); the
trained fields like the mapping-phase test (99% within 5e-4 + 1e-3 rel,
and every entry within lr x the run's mapping iterations)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_util import np_
from vtgaussian_slam_tpu.core import pipeline as JP
from vtgaussian_slam_tpu.datasets.synthetic import \
    SyntheticRoomDataset as JSynth
from vtgaussian_slam_tpu.ops import image as JI
from vtgaussian_slam_tpu_torch.core import pipeline as TP
from vtgaussian_slam_tpu_torch.datasets.synthetic import \
    SyntheticRoomDataset as TSynth
from vtgaussian_slam_tpu_torch.ops import image as TI

FRAMES = 3
ITERS = 4


def _config(workdir):
    # auto_pair_budget off on both sides: the JAX engine's closed-loop
    # truncation probe (not in this slice) may re-bucket the pair budget
    # mid-run; the open-loop formula is held by test_auto_pair_budget_matches
    return dict(
        workdir=str(workdir), run_name="slice", seed=5, map_every=1,
        keyframe_every=1, scene_radius_depth_ratio=3,
        gaussian_distribution="isotropic", use_wandb=False,
        baseframe_every=6, selection_style="replica",
        data=dict(dataset_name="synthetic",
                  synthetic=dict(num_frames=8, height=40, width=48, seed=1,
                                 motion_scale=0.1),
                  sequence="slice", desired_image_height=40,
                  desired_image_width=48, densification_image_height=80,
                  densification_image_width=96, start=0, end=-1, stride=1,
                  num_frames=-1),
        tracking=dict(use_gt_poses=False, num_iters=ITERS,
                      base1_num_iters=ITERS, use_sil_for_loss=True,
                      sil_thres=0.99, ignore_outlier_depth_loss=False,
                      loss_weights=dict(im=0.5, depth=0.025),
                      lrs=dict(means3D=0.0, rgb_colors=0.0,
                               unnorm_rotations=0.0, logit_opacities=0.0,
                               log_scales=0.0, cam_unnorm_rots=0.0004,
                               cam_trans=0.002)),
        mapping=dict(num_iters=ITERS, add_new_gaussians=True, sil_thres=0.5,
                     use_sil_for_loss=False, ignore_outlier_depth_loss=False,
                     loss_weights=dict(im=1.0, depth=1.0),
                     lrs=dict(means3D=0.0, rgb_colors=0.0025,
                              unnorm_rotations=0.0, logit_opacities=0.05,
                              log_scales=0.005, cam_unnorm_rots=1e-8,
                              cam_trans=1e-7)),
        tpu=dict(capacity_quantum=4096, span_cap=2, max_pairs_per_tile=1024,
                 auto_pair_budget=False, blend_chunk=128, use_pallas=True,
                 map_binned=True, track_cache=True, importance_binning=True,
                 prefetch=0),
    )


@pytest.mark.parametrize("sensor", [None, {}])
def test_synthetic_frames_and_edge_masks_bit_identical(sensor):
    kw = dict(num_frames=5, height=40, width=48, seed=3, motion_scale=0.2,
              sensor=sensor)
    for res in ({}, dict(desired_height=80, desired_width=96)):
        j, t = JSynth(**kw, **res), TSynth(**kw, **res)
        for i in (0, 3):
            for a, b in zip(j[i], t[i]):
                np.testing.assert_array_equal(a, b)
        col = j[2][0].astype(np.uint8)
        np.testing.assert_array_equal(
            TI.geometric_edge_mask(col),
            JI._canny_numpy(col, RGB=True, dilate=True))
        m = TI.geometric_edge_mask(col)
        np.testing.assert_array_equal(TI.resize_mask_nearest(m, 96, 80),
                                      JI.resize_mask_nearest(m, 96, 80))


@pytest.mark.parametrize("args", [(900_000, 3225, 2, 512), (2500, 9, 2, 128),
                                  (5_000_000, 3225, 2, 512, 4)])
def test_auto_pair_budget_matches(args):
    assert TP.auto_pair_budget(*args) == JP.auto_pair_budget(*args)


def test_three_frames_match_jax_engine(tmp_path, monkeypatch):
    monkeypatch.setattr(JI, "cv2", None)        # the numpy Canny on both
    cfg = _config(tmp_path)
    jeng = JP.VTGaussianSLAM(cfg)
    # the JAX engine's only key splits on this path: one per mapping phase
    rng = jax.random.PRNGKey(cfg["seed"])
    draws = {}
    for t in range(FRAMES):
        rng, k = jax.random.split(rng)
        draws[t] = [int(jax.random.randint(jax.random.fold_in(k, i), (), 0,
                                           jnp.asarray(t + 1, jnp.int32)))
                    for i in range(ITERS)]
    j_n = [int(jeng.sections[0].n_active)]
    jeng.process_frame_zero()
    for t in range(1, FRAMES):
        jeng.process_frame(t)
        j_n.append(int(jeng.sections[0].n_active))

    teng = TP.VTGaussianSLAM(cfg, device="cpu",
                             map_draws=lambda t, n, count: (
                                 draws[t][:n] if t in draws else None))
    t_n = [teng.sections[0].n_active]
    for t in range(FRAMES):
        teng.process_frame(t)
        if t:
            t_n.append(teng.sections[0].n_active)
    assert t_n == j_n
    assert j_n[-1] > j_n[0], "densification added Gaussians"
    np.testing.assert_allclose(np_(teng.traj.quats[:FRAMES]),
                               np.asarray(jeng.traj.quats[:FRAMES]), atol=2e-4)
    np.testing.assert_allclose(np_(teng.traj.trans[:FRAMES]),
                               np.asarray(jeng.traj.trans[:FRAMES]), atol=2e-4)
    jp = jeng.sections[0].params
    tp = teng.sections[0].params
    n = j_n[-1]
    np.testing.assert_allclose(np_(tp.means3d[:n]), np.asarray(jp.means3d[:n]),
                               rtol=1e-5, atol=1e-5)
    lrs = cfg["mapping"]["lrs"]
    for f in ("rgb_colors", "logit_opacities", "log_scales"):
        a, b = np_(getattr(tp, f)[:n]), np.asarray(getattr(jp, f)[:n])
        close = np.abs(a - b) <= 5e-4 + 1e-3 * np.abs(b)
        assert close.mean() > 0.99, (f, close.mean())
        # every entry within lr * (mapping iterations of the run), the most
        # Adam moves an entry: an outlier past it is a fault, not rounding
        reach = lrs[f] * FRAMES * ITERS
        assert np.abs(a - b).max() <= reach, (f, np.abs(a - b).max() / reach)
    # frame baseframe_every is a section boundary: it spawns section 1
    teng.process_frame(cfg["baseframe_every"])
    assert len(teng.sections) == 2 and teng.sections[1].n_active > 0
    assert teng.fixed_section_ids == (0, 0)


def test_cli_runs_the_first_frames(tmp_path, capsys):
    from vtgaussian_slam_tpu_torch.__main__ import main
    cfg = _config(tmp_path)
    path = tmp_path / "tiny_config.py"
    path.write_text(f"config = {cfg!r}\n")
    assert main([str(path), "--frames", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "frame 1:" in out and "PSNR" in out and "ATE:" in out
