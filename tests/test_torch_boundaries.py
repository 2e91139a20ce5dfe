"""Section boundaries end to end against the JAX engine.

Both engines run the 40 x 48 replica-style proxy of test_torch_slice.py
with baseframe_every 3 for 10 frames on the kernel routes (the JAX
engine's Pallas kernels in interpret mode), 4 iterations per phase:
boundaries at frames 3, 6 and 9 select the sections by the 1600-pixel
overlap scoring and the earliest-chain walk, track with the
point-to-plane candidate metric, spawn sections 1 to 3, and map with the
global term against the frozen sections; the sections outside the hot set
are paged out and back in. The port gets the JAX engine's random draws injected: the pixel
ranks of every sampled overlap scoring (wrapping the JAX engine's
`overlap_percents`) and every mapping phase's keyframe draws (wrapping its
mapping loops), since `jax.random` and torch generators give different
streams.

A second port run turns section paging off and must give the same bits
(the tum-style route is held in test_torch_boundaries_tum.py).

Each frame's tracking starts from the JAX engine's state: once the port
has tracked a frame, its pose is kept for the comparison and the JAX
engine's committed pose goes into its trajectory, so that spawning,
densification and mapping see the same poses on both sides (without it,
one near-tie below lets the trajectories drift apart through the
constant-velocity init, and nothing after it is comparable).

Tolerances: section counts, per-section Gaussian counts, the selections,
fixed_section_ids and the paging lists exact; each section's means within
1e-5 at the pose they were built from (torch_port_util.
assert_means_at_own_poses: the port densifies and spawns at the JAX
engine's pose, which its trajectory holds); tracked poses within 2e-4 (a
few Adam steps of lr 4e-4 / 2e-3 carrying the kernels' ~1e-4 relative
differences), but for one frame at most whose best candidate lands on
another iteration of a near tie, held to one Adam step; the trained fields
on the JAX engine's own rounding spread, as test_torch_slice.py holds them
(torch_port_util.assert_fields_within_spread; the JAX engine's runs on
frames one ulp off take the unperturbed run's poses, as the port does),
and every entry within lr x the mapping iterations of the run: a
section here takes up to four mapping phases, and a Gaussian at the edge
of a tile's reach (the binning's radius test on projections that differ by
an ulp: XLA contracts the projection into FMAs, the port rounds each
operation as written) is binned on one side only, so its gradient differs
every iteration and Adam moves it several steps apart"""
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util
import vtgaussian_slam_tpu.core.mapping as JM
from test_torch_slice import _config
from torch_port_util import (assert_fields_within_spread,  # noqa: F401
                             assert_means_at_own_poses, first_exp_spent,
                             jax_spread, np_, section_fields)
from vtgaussian_slam_tpu.core import pipeline as JP
from vtgaussian_slam_tpu.ops import image as JI
from vtgaussian_slam_tpu_torch.core import pipeline as TP

ITERS = 4
FRAMES = 10


def _key_draws(k, n, count):
    return [int(jax.random.randint(jax.random.fold_in(k, i), (), 0, count))
            for i in range(n)]


class _Recorder:
    """The JAX engine's random draws, per frame, by wrapping its module
    names: the overlap scorer's pixel ranks and the mapping loops' keys."""

    def __init__(self, mp):
        self.t = 0
        self.ranks = defaultdict(list)
        self.draws = {}
        op, mfb, mf = JP.overlap_percents, JM.map_frame_binned, JP.map_frame

        def overlap(gt_depth, w2c, K, kf_w2cs, kf_depths, rng, pixels=1600,
                    **kw):
            if pixels > 0:
                n_valid = jnp.sum((gt_depth.reshape(-1) > 0).astype(jnp.int32))
                self.ranks[self.t].append(np.asarray(jax.random.randint(
                    rng, (pixels,), 0, jnp.maximum(n_valid, 1))))
            return op(gt_depth, w2c, K, kf_w2cs, kf_depths, rng,
                      pixels=pixels, **kw)

        def binned(params, kf, kfc, slot_ids, gc, rng, cam, cfg):
            self.draws[self.t] = _key_draws(rng, cfg.num_iters, kf.count)
            return mfb(params, kf, kfc, slot_ids, gc, rng, cam, cfg)

        def generic(params, active, fp, fa, kf, rng, cam, cfg):
            self.draws[self.t] = _key_draws(rng, cfg.num_iters, kf.count)
            return mf(params, active, fp, fa, kf, rng, cam, cfg)

        mp.setattr(JP, "overlap_percents", overlap)
        mp.setattr(JM, "map_frame_binned", binned)
        mp.setattr(JP, "map_frame", generic)

    def port_hooks(self):
        used = defaultdict(int)

        def ranks(t):
            used[t] += 1
            return self.ranks[t][used[t] - 1]

        return dict(map_draws=lambda t, n, count: self.draws[t][:n],
                    overlap_ranks=ranks)


def _jax_paged(eng):
    return [i for i, s in enumerate(eng.sections)
            if isinstance(s.params.means3d, np.ndarray)]


def _state(eng, port: bool):
    """What the two engines must agree on exactly after a frame."""
    return dict(
        n=[int(s.n_active) for s in eng.sections],
        fixed=(tuple(int(i) for i in eng.fixed_section_ids)
               if eng.fixed_section_ids is not None else None),
        tracking_corr=[list(c) for c in eng.tracking_corr],
        earliest_corr=[list(c) for c in eng.earliest_corr],
        mapping_corr=[list(c) for c in eng.mapping_corr],
        paged=eng.paged_sections() if port else _jax_paged(eng),
        ins=eng.stats.get("section_page_ins", 0),
        outs=eng.stats.get("section_page_outs", 0),
        baseframes=list(eng.baseframes.ids))


def _run_pair(tmp_path, cfg, frames):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JI, "cv2", None)         # the numpy Canny on both
        rec = _Recorder(mp)
        jeng = JP.VTGaussianSLAM(cfg)
        jstates = []
        for t in range(frames):
            rec.t = t
            if t == 0:
                jeng.process_frame_zero()
            else:
                jeng.process_frame(t)
            jstates.append(_state(jeng, False))
        jeng._page_cold_finish()
        jstates.append(_state(jeng, False))
    teng, tstates, tracked = _port_run(cfg, rec, jeng, frames)
    return jeng, teng, jstates, tstates, rec, tracked


def _port_run(cfg, rec, jeng, frames):
    """The port over the same frames with the JAX engine's draws, each
    frame's tracking started from the JAX engine's state: once the port has
    tracked frame t, its own pose is kept aside and the JAX engine's goes
    into the trajectory, so that spawning, densification, mapping and the
    next frame's init all see the same poses on both sides. Returns (engine,
    per-frame states, {t: the port's tracked (quat, trans)})."""
    teng = TP.VTGaussianSLAM(cfg, device="cpu", **rec.port_hooks())
    jq, jt = np.asarray(jeng.traj.quats), np.asarray(jeng.traj.trans)
    tracked = {}
    track = teng._track

    def track_then_take_jax_pose(t, frame):
        sec_id = track(t, frame)
        tracked[t] = (np_(teng.traj.quats[t]).copy(),
                      np_(teng.traj.trans[t]).copy())
        teng._traj_write(t, torch.as_tensor(jq[t]), torch.as_tensor(jt[t]))
        return sec_id

    teng._track = track_then_take_jax_pose
    states = []
    for t in range(frames):
        teng.process_frame(t)
        states.append(_state(teng, True))
    teng._page_cold_finish()
    states.append(_state(teng, True))
    return teng, states, tracked


def _replica_config(tmp_path):
    cfg = _config(tmp_path)
    cfg["baseframe_every"] = 3
    cfg["data"]["synthetic"]["num_frames"] = 10
    # one capacity (8192) for every section and 16384 for the frozen
    # concat: fewer distinct shapes for the JAX engine to compile
    cfg["tpu"]["capacity_quantum"] = 8192
    return cfg


@pytest.fixture(scope="module")
def replica(tmp_path_factory):
    cfg = _replica_config(tmp_path_factory.mktemp("replica"))
    return (cfg,) + _run_pair(tmp_path_factory, cfg, FRAMES)


def _assert_poses(tracked, jeng, lrs, flips=1):
    """Each frame's tracked pose within 2e-4 of the JAX engine's from the
    same state, but for at most `flips` frames whose best-candidate argmin
    falls on another iteration of a near tie (the loss or p2p values of two
    iterations within the kernels' ~1e-4): those within one Adam step."""
    off = []
    for t, (q, tr) in sorted(tracked.items()):
        dq = np.abs(q - np.asarray(jeng.traj.quats[t])).max()
        dt = np.abs(tr - np.asarray(jeng.traj.trans[t])).max()
        assert dq <= lrs["cam_unnorm_rots"] and dt <= lrs["cam_trans"], (
            t, dq, dt)
        if max(dq, dt) > 2e-4:
            off.append((t, dq, dt))
    assert len(off) <= flips, off


def _jax_spread(cfg, jeng, frames):
    """The JAX engine's rounding spread on this run: runs on one-ulp
    frames, each tracked pose replaced by the first run's."""
    return jax_spread(cfg, frames, section_fields(jeng, False),
                      pin_poses=(np.asarray(jeng.traj.quats),
                                 np.asarray(jeng.traj.trans)))


def _assert_fields(teng, jeng, cfg, frames, spread):
    for j_sec, t_sec in zip(jeng.sections, teng.sections):
        assert_means_at_own_poses(t_sec, j_sec, teng.traj, jeng.traj,
                                  int(j_sec.n_active))
    assert_fields_within_spread(section_fields(teng, True),
                                section_fields(jeng, False), spread,
                                cfg["mapping"]["lrs"], frames * ITERS)


@pytest.fixture(scope="module")
def replica_spread(replica):
    cfg, jeng, *_ = replica
    return _jax_spread(cfg, jeng, FRAMES)


def test_replica_field_fault_fails_the_parity_check(replica, replica_spread):
    """Negative control of the yardstick on this run's four sections: the
    port with K3's opacity row lacking the sigmoid's (1 - sig) factor
    fails the logit field check alone (sections 0 and 1, each on its own
    spread: 46-47% of logits outside the band where 26-33% are allowed;
    the fault also moves rgb and 18 densified means, which other checks
    catch first)."""
    from test_torch_parity_controls import _k3_opacity_without_sigmoid_factor
    cfg, jeng, _, _, _, rec, _ = replica
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JI, "cv2", None)
        _k3_opacity_without_sigmoid_factor(mp)
        teng, _, _ = _port_run(cfg, rec, jeng, FRAMES)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_port_util, "FIELDS", ("logit_opacities",))
        with pytest.raises(AssertionError, match="logit_opacities"):
            assert_fields_within_spread(section_fields(teng, True),
                                        section_fields(jeng, False),
                                        replica_spread, cfg["mapping"]["lrs"],
                                        FRAMES * ITERS)


def test_replica_sections_and_selections_match(replica):
    cfg, jeng, teng, jstates, tstates, rec, _ = replica
    for t, (j, p) in enumerate(zip(jstates, tstates)):
        assert p == j, (t, p, j)
    assert len(teng.sections) == 4
    assert tstates[-1]["outs"] >= 1, "nothing was paged out"
    # every boundary scored once for tracking; the later ones once more
    # for the mapping overlap
    assert [len(rec.ranks[t]) for t in (3, 6, 9)] == [1, 2, 2]


def test_replica_poses_match(replica):
    cfg, jeng, teng, *_, tracked = replica
    assert sorted(tracked) == list(range(1, FRAMES))
    _assert_poses(tracked, jeng, cfg["tracking"]["lrs"])


def test_replica_trained_fields_match(replica, replica_spread):
    cfg, jeng, teng, *_ = replica
    _assert_fields(teng, jeng, cfg, FRAMES, replica_spread)


def test_paging_off_gives_the_same_bits(replica):
    cfg, jeng, teng, jstates, tstates, rec, tracked = replica
    cfg = dict(cfg, tpu=dict(cfg["tpu"], section_paging=False))
    off, states, tracked_off = _port_run(cfg, rec, jeng, FRAMES)
    assert off.paged_sections() == [] and off.stats["section_page_outs"] == 0
    assert [s["n"] for s in states] == [s["n"] for s in tstates]
    for a, b in zip(off.sections, teng.sections):
        assert a.n_active == b.n_active
        for x, y in zip(a.params.tensors(), b.params.tensors()):
            assert np.array_equal(np_(x), np_(y))
    for t, (q, tr) in tracked.items():
        assert np.array_equal(q, tracked_off[t][0])
        assert np.array_equal(tr, tracked_off[t][1])
