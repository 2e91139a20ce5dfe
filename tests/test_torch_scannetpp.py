"""The ScanNet++ route end to end against the JAX engine: the initial-error
probe, the tracking rescue and the visual odometer.

Both engines run `make_config("scannetpp", "proxy")` on synthetic frames
at 48 x 64 (densification at 96 x 128) for 4 frames, 3 iterations per
phase, with init_err_ratio 0, so that the rescue fires and the odometer
re-initializes the pose on every frame from frame 2 on. The port gets the
JAX engine's mapping keyframe draws, and after each tracked frame the JAX
engine's committed pose goes into the port's trajectory (the port's own is
kept for the comparison), as in test_torch_boundaries.py.

Exact: the rescue decisions, the iteration count of every tracking call,
the length of the frame_color_loss / frame_depth_loss histories and the
Gaussian counts. Within a tolerance: the probe losses and the histories
within rtol 1e-3 (renders that agree to ~1e-5, summed over the frame);
the odometer's relative pose within 1e-4 (its float32 6x6 solves round
differently, see test_torch_odometry.py); the tracked poses within 2e-4
(a few Adam steps of lr 1e-3 / 1e-2 carrying the kernels' ~1e-4 relative
differences)."""
import numpy as np
import pytest

import vtgaussian_slam_tpu.core.tracking as JT
from configs.common import make_config
from test_torch_boundaries import _port_run, _Recorder
from torch_port_util import first_exp_spent, one_thread  # noqa: F401
from vtgaussian_slam_tpu.core import pipeline as JP
from vtgaussian_slam_tpu.ops import image as JI

FRAMES = 4
ITERS = 3


def _config(workdir):
    cfg = make_config("scannetpp", "proxy", seed=2)
    cfg["workdir"] = str(workdir)
    cfg["use_wandb"] = False
    cfg["init_err_ratio"] = 0
    cfg["data"] = dict(
        dataset_name="synthetic",
        synthetic=dict(num_frames=8, height=48, width=64, seed=1,
                       motion_scale=0.1),
        sequence="proxy", desired_image_height=48, desired_image_width=64,
        densification_image_height=96, densification_image_width=128,
        start=0, end=-1, stride=1, num_frames=-1)
    cfg["tracking"]["num_iters"] = cfg["tracking"]["base1_num_iters"] = ITERS
    cfg["mapping"]["num_iters"] = ITERS
    cfg["tpu"] = dict(capacity_quantum=8192, span_cap=3,
                      max_pairs_per_tile=512, auto_pair_budget=False,
                      blend_chunk=128, prefetch=0)
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = _config(tmp_path_factory.mktemp("scannetpp"))
    probes, rels, iters = {}, {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JI, "cv2", None)         # the numpy Canny on both
        rec = _Recorder(mp)
        probe = JT.probe_loss

        def probe_rec(*a, **kw):
            out = probe(*a, **kw)
            probes[rec.t] = (float(out[0]), float(out[1]))
            return out

        mp.setattr(JT, "probe_loss", probe_rec)
        jeng = JP.VTGaussianSLAM(cfg)
        assert jeng.dataset_name == "scannetpp" and jeng.odometer is not None
        estimate = jeng.odometer.estimate_rel_pose

        def estimate_rec(*a, **kw):
            rels[rec.t] = estimate(*a, **kw)
            return rels[rec.t]

        jeng.odometer.estimate_rel_pose = estimate_rec
        run_track = jeng._run_track

        def run_track_rec(sec, state, frame, aux, p2p, tcfg):
            iters.setdefault(rec.t, []).append(tcfg.num_iters)
            return run_track(sec, state, frame, aux, p2p, tcfg)

        jeng._run_track = run_track_rec
        for t in range(FRAMES):
            rec.t = t
            if t == 0:
                jeng.process_frame_zero()
            else:
                jeng.process_frame(t)
    teng, _, tracked = _port_run(cfg, rec, jeng, FRAMES)
    return cfg, jeng, teng, tracked, probes, rels, iters


def test_rescue_decisions_and_iterations_match(runs):
    cfg, jeng, teng, tracked, probes, rels, iters = runs
    log = {r["t"]: r for r in teng.rescue_log}
    assert sorted(log) == sorted(probes) == list(range(1, FRAMES))
    fired = {t: r["fired"] for t, r in log.items()}
    assert fired == {1: False, **{t: True for t in range(2, FRAMES)}}
    assert sorted(rels) == [t for t in fired if fired[t]]
    for t, r in log.items():
        assert r["num_iters"] == (2 * ITERS if fired[t] else ITERS)
        assert [r["num_iters"]] == iters[t], (t, iters[t])
        np.testing.assert_allclose([r["probe_im"], r["probe_depth"]],
                                   probes[t], rtol=1e-3)
    assert len(teng.frame_color_loss) == len(jeng.frame_color_loss) == \
        FRAMES - 1
    np.testing.assert_allclose(teng.frame_color_loss, jeng.frame_color_loss,
                               rtol=1e-3)
    np.testing.assert_allclose(teng.frame_depth_loss, jeng.frame_depth_loss,
                               rtol=1e-3)
    assert [s.n_active for s in teng.sections] == \
        [int(s.n_active) for s in jeng.sections]


def test_odometer_and_poses_match(runs):
    cfg, jeng, teng, tracked, probes, rels, iters = runs
    for r in teng.rescue_log:
        if r["fired"]:
            np.testing.assert_allclose(r["odometer_rel"], rels[r["t"]],
                                       atol=1e-4, rtol=0)
    for t, (q, tr) in sorted(tracked.items()):
        np.testing.assert_allclose(q, np.asarray(jeng.traj.quats[t]),
                                   atol=2e-4, rtol=0)
        np.testing.assert_allclose(tr, np.asarray(jeng.traj.trans[t]),
                                   atol=2e-4, rtol=0)
