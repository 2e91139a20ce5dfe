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
Gaussian counts. Within a tolerance: the probe losses within rtol 1e-3
(renders that agree to ~1e-5, summed over the frame, at the propagated
pose); the odometer's relative pose within 1e-4 (its float32 6x6 solves
round differently, see test_torch_odometry.py); the tracked poses within
2e-4 (a few Adam steps of lr 1e-3 / 1e-2 carrying the kernels' ~1e-4
relative differences).

The histories (each tracked frame's final-iteration losses) are held on
the JAX engine's own rounding spread (`assert_histories_within_spread`):
per frame, |port - JAX| within SPREAD_K times the largest change of JAX's
value over its runs on frames one ulp up (torch_port_util.NUDGES, each
given the unperturbed run's poses, as the port is), and at least 1e-5 of
it. They were held at rtol 1e-3, which lies inside that spread: JAX's own
frame-2 depth loss moves by 2.3e-2 under a one-ulp depth nudge, its frame-1
colour loss by 1.9e-3. The port's frame-2 depth loss sat 2.3e-5 off JAX's
on MKL's default sgemm path of an AVX-512 host and 9.6e-4 off (0.965 of
the old limit) under MKL_ENABLE_INSTRUCTIONS=AVX2, with the odometer's
pose within 1e-6 on both: the last tracking iteration's loss carries the
rounding of every Adam step before it. test_torch_parity_controls.py
holds a wrong odometer init against the re-based check."""
import numpy as np
import pytest

import vtgaussian_slam_tpu.core.tracking as JT
from configs.common import make_config
from test_torch_boundaries import _port_run, _Recorder
from torch_port_util import (NUDGES, SPREAD_K, first_exp_spent,  # noqa: F401
                             one_thread, one_ulp_frames, pin_jax_poses)
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


def jax_histories(cfg, nudge, poses):
    """(frame_color_loss, frame_depth_loss) of the JAX engine on frames one
    ulp up (`nudge` of torch_port_util.NUDGES), with `poses` ((quats,
    trans) of the unperturbed run) put into its trajectory after each
    tracked frame."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JI, "cv2", None)
        one_ulp_frames(mp, *NUDGES[nudge])
        eng = JP.VTGaussianSLAM(cfg)
        pin_jax_poses(mp, eng, poses)
        for t in range(FRAMES):
            if t == 0:
                eng.process_frame_zero()
            else:
                eng.process_frame(t)
    return np.array(eng.frame_color_loss), np.array(eng.frame_depth_loss)


def history_spread(cfg, jeng) -> dict:
    """{"color", "depth": per frame, the largest |nudged - unperturbed| of
    the JAX engine's history over the three nudges}."""
    poses = (np.asarray(jeng.traj.quats), np.asarray(jeng.traj.trans))
    ref = (np.array(jeng.frame_color_loss), np.array(jeng.frame_depth_loss))
    runs = [jax_histories(cfg, n, poses) for n in NUDGES]
    return {k: np.max([np.abs(r[i] - ref[i]) for r in runs], axis=0)
            for i, k in enumerate(("color", "depth"))}


def assert_histories_within_spread(teng, jeng, spread) -> None:
    """Each history of the port within max(SPREAD_K x the JAX engine's
    one-ulp spread, 1e-5 |JAX|) of JAX's, frame by frame; prints the
    largest gap over its limit."""
    for k in ("color", "depth"):
        got = np.array(getattr(teng, f"frame_{k}_loss"))
        ref = np.array(getattr(jeng, f"frame_{k}_loss"))
        assert got.shape == ref.shape == spread[k].shape, (k, got, ref)
        limit = np.maximum(SPREAD_K * spread[k], 1e-5 * np.abs(ref))
        ratio = np.abs(got - ref) / limit
        print(f"frame_{k}_loss: port {got}, JAX {ref}, JAX's one-ulp "
              f"spread {spread[k]}; largest gap / limit {ratio.max():.4f}")
        assert (ratio <= 1).all(), (
            f"frame_{k}_loss outside the JAX engine's spread: gap / limit "
            f"{ratio}")


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
    return cfg, jeng, teng, tracked, probes, rels, iters, rec


@pytest.fixture(scope="module")
def spread(runs):
    return history_spread(runs[0], runs[1])


def test_rescue_decisions_and_iterations_match(runs, spread):
    cfg, jeng, teng, tracked, probes, rels, iters, _ = runs
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
    assert_histories_within_spread(teng, jeng, spread)
    assert [s.n_active for s in teng.sections] == \
        [int(s.n_active) for s in jeng.sections]


def test_odometer_and_poses_match(runs):
    cfg, jeng, teng, tracked, probes, rels, iters, _ = runs
    for r in teng.rescue_log:
        if r["fired"]:
            np.testing.assert_allclose(r["odometer_rel"], rels[r["t"]],
                                       atol=1e-4, rtol=0)
    for t, (q, tr) in sorted(tracked.items()):
        np.testing.assert_allclose(q, np.asarray(jeng.traj.quats[t]),
                                   atol=2e-4, rtol=0)
        np.testing.assert_allclose(tr, np.asarray(jeng.traj.trans[t]),
                                   atol=2e-4, rtol=0)
