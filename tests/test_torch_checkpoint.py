"""Checkpoint and resume: the port against itself and across packages.

- The smoke config at 24 x 32 (3 iterations per phase, baseframe_every
  5): an uninterrupted `run` of 8 frames that saves every 4 frames, and a
  fresh engine that resumes from frame 3 through `run` (load_checkpoint,
  checkpoint_time_idx 3). Frame 3 is mid-section on the CPU's generic
  mapping route, and no truncation-probe reading is in flight there (the
  test asserts it): the resumed run's sections, trajectory and export are
  equal to the bit to the uninterrupted run's. A second case takes the
  binned mapping route (tpu.map_binned on) and saves at frame 4, the
  section's last frame, as phase 2f-a does on the card.
- A JAX-written checkpoint loads into the port with every array equal to
  the bit, and a port-written one into the JAX engine.
- `run` picks the newest checkpoint when checkpoint_time_idx is 0, the
  named one otherwise, and falls back to the previous file when the
  newest is truncated."""
import os

import numpy as np
import pytest

from torch_port_util import np_, one_thread, smoke_config  # noqa: F401
from vtgaussian_slam_tpu.core.pipeline import VTGaussianSLAM as JEngine
from vtgaussian_slam_tpu.utils import checkpoint as JC
from vtgaussian_slam_tpu_torch.core.pipeline import VTGaussianSLAM as TEngine
from vtgaussian_slam_tpu_torch.utils import checkpoint as TC

FRAMES = 8


def _smoke(workdir, **over):
    return smoke_config(workdir, frames=FRAMES, **over)


def _state(eng):
    """Each section's fields and timesteps over its live rows (the padded
    tail of a restored section is zeros, the uninterrupted run's holds the
    rows spawning cut), the trajectory and the export."""
    return ([[np_(x[:s.n_active]).copy() for x in s.params.tensors()]
             + [np_(s.vars.timestep[:s.n_active]).copy(), s.n_active]
             for s in eng.sections],
            np_(eng.traj.quats).copy(), np_(eng.traj.trans).copy(),
            eng.export_params_ls())


def _assert_equal_states(a, b):
    (sa, qa, ta, ea), (sb, qb, tb, eb) = a, b
    assert len(sa) == len(sb)
    for x, y in zip(sa, sb):
        assert x[-1] == y[-1]
        for u, v in zip(x[:-1], y[:-1]):
            assert np.array_equal(u, v)
    assert np.array_equal(qa, qb) and np.array_equal(ta, tb)
    for pa, pb in zip(ea, eb):
        for k in pa:
            assert np.array_equal(pa[k], pb[k]), k


ROUTES = {"generic": (dict(), 4, 3), "binned": (dict(map_binned=True), 5, 4)}


@pytest.fixture(scope="module", params=sorted(ROUTES))
def resumed(request, tmp_path_factory):
    tpu, interval, save_t = ROUTES[request.param]
    root = tmp_path_factory.mktemp(request.param)
    cfg = _smoke(root, save_checkpoints=True, checkpoint_interval=interval,
                 tpu=tpu)
    full = TEngine(cfg, device="cpu")
    in_flight = {}
    full.run(on_frame=lambda t: in_flight.setdefault(
        t, full._pending_harm is not None))
    want = _state(full)
    cfg2 = _smoke(root, load_checkpoint=True, checkpoint_time_idx=save_t,
                  tpu=tpu)
    again = TEngine(cfg2, device="cpu")
    again.run()
    return dict(route=request.param, save_t=save_t, full=full, want=want,
                again=again, in_flight=in_flight, cfg=cfg)


def test_resume_is_bit_equal_to_the_uninterrupted_run(resumed):
    assert resumed["in_flight"][resumed["save_t"]] is False
    assert resumed["full"].map_binned == (resumed["route"] == "binned")
    assert resumed["again"].frames_done == FRAMES
    assert resumed["again"].checkpoint_log[0]["t"] == resumed["save_t"]
    _assert_equal_states(_state(resumed["again"]), resumed["want"])


def test_run_saves_on_the_interval(resumed):
    ckdir = TC.checkpoint_dir(resumed["cfg"])
    interval = ROUTES[resumed["route"]][1]
    want = [f"ckpt_{t:06d}.npz" for t in range(1, FRAMES)
            if (t + 1) % interval == 0]
    assert sorted(os.listdir(ckdir)) == want
    saved = [c["t"] for c in resumed["full"].checkpoint_log]
    assert saved == [t for t in range(1, FRAMES) if (t + 1) % interval == 0]


def test_resume_keeps_the_densify_counts(resumed):
    """num_gs_per_frame_ls (each section's initial count, then each
    densify's additions) survives the checkpoint: the resumed run's list
    equals the uninterrupted run's, one entry per section and densify."""
    full, again = resumed["full"], resumed["again"]
    assert again.num_gs_per_frame_ls == full.num_gs_per_frame_ls
    assert len(full.num_gs_per_frame_ls) == FRAMES
    assert sum(full.num_gs_per_frame_ls) >= sum(
        s.n_active for s in full.sections)


def test_port_file_holds_the_stats_a_jax_engine_adds_to(resumed, tmp_path):
    """A JAX engine takes a checkpoint's stats whole and adds to each: the
    port's file holds every key of the JAX engine's stats, and the four
    per-iteration sums the port does not keep read 0 there (a resumed JAX
    engine's averages of them cover its own frames)."""
    path = os.path.join(TC.checkpoint_dir(resumed["cfg"]),
                        f"ckpt_{resumed['save_t']:06d}.npz")
    saved = TC._read(path)[1]["stats"]
    for k in ("tracking_iter_time_sum", "tracking_iter_count",
              "mapping_iter_time_sum", "mapping_iter_count"):
        assert saved[k] == 0.0, k
    assert set(JEngine(_smoke(tmp_path)).stats) <= set(saved)


def test_latest_and_truncated_fallback(tmp_path, capsys):
    cfg = _smoke(tmp_path, save_checkpoints=True, checkpoint_interval=2)
    TEngine(cfg, device="cpu").run(num_frames=6)
    ckdir = TC.checkpoint_dir(cfg)
    assert sorted(os.listdir(ckdir)) == ["ckpt_000001.npz", "ckpt_000003.npz",
                                         "ckpt_000005.npz"]
    eng = TEngine(_smoke(tmp_path, load_checkpoint=True,
                         checkpoint_time_idx=0), device="cpu")
    assert TC.load_checkpoint(eng) == 6
    newest = os.path.join(ckdir, "ckpt_000005.npz")
    with open(newest, "r+b") as f:
        f.truncate(100)
    eng = TEngine(_smoke(tmp_path, load_checkpoint=True,
                         checkpoint_time_idx=0), device="cpu")
    eng.run(num_frames=5)
    out = capsys.readouterr().out
    assert "ckpt_000005.npz unreadable" in out
    assert "Resumed from checkpoint at frame 3" in out
    assert eng.frames_done == 5
    eng = TEngine(_smoke(tmp_path, load_checkpoint=True,
                         checkpoint_time_idx=1), device="cpu")
    assert TC.load_checkpoint(eng, time_idx=1) == 2


def _jax_arrays(eng):
    n = len(eng.sections)
    out = {f"sec{i}_{k}": np.asarray(getattr(eng.sections[i].params, a))[
        :int(eng.sections[i].n_active)]
        for i in range(n) for k, a in (
            ("means3D", "means3d"), ("rgb_colors", "rgb_colors"),
            ("unnorm_rotations", "unnorm_rotations"),
            ("logit_opacities", "logit_opacities"),
            ("log_scales", "log_scales"))}
    for i in range(n):
        s = eng.sections[i]
        out[f"sec{i}_timestep"] = np.asarray(s.vars.timestep)[:int(s.n_active)]
    nb = len(eng.baseframes)
    out.update(traj_quats=np.asarray(eng.traj.quats),
               traj_trans=np.asarray(eng.traj.trans),
               gt_w2c=np.stack(eng.gt_w2c),
               baseframe_depths=np.asarray(eng.baseframes.depths)[:nb],
               baseframe_quats=np.asarray(eng.baseframes.quats)[:nb],
               baseframe_trans=np.asarray(eng.baseframes.trans)[:nb],
               ring_colors=np.asarray(eng.ring_colors),
               ring_depths=np.asarray(eng.ring_depths))
    return out


def _lists(eng):
    return (eng.tracking_corr, eng.mapping_corr, list(eng.baseframes.ids),
            (tuple(eng.fixed_section_ids) if eng.fixed_section_ids
             else None), list(eng.depth_means), eng._mpt_boost,
            list(eng._harm_hist), eng._frames_tracked,
            [int(n) for n in eng.num_gs_per_frame_ls])


def test_checkpoints_load_across_packages(tmp_path, capsys):
    # the JAX engine through frame 6: two sections and a fixed pair
    jcfg = _smoke(tmp_path / "jax")
    jeng = JEngine(jcfg)
    jeng.process_frame_zero()
    for t in range(1, 7):
        jeng.process_frame(t)
    jeng._page_cold_finish()
    jpath = JC.save_checkpoint(jeng, 6)
    port = TEngine(_smoke(tmp_path / "port"), device="cpu")
    assert TC.load_checkpoint(port, jpath) == 7
    assert "no torch generator states" in capsys.readouterr().out
    ref = _jax_arrays(jeng)
    got = _jax_arrays(port)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype or k == "gt_w2c", k
        assert np.array_equal(got[k], ref[k]), k
    assert _lists(port) == _lists(jeng)
    assert port.frames_done == 7 and len(port.sections) == 2

    # and back: the port's file into a fresh JAX engine
    ppath = TC.save_checkpoint(port, 6)
    data = np.load(ppath)
    assert set(np.load(jpath).files) - {"jax_rng_key"} <= set(data.files)
    jeng2 = JEngine(_smoke(tmp_path / "jax2"))
    assert JC.load_checkpoint(jeng2, ppath) == 7
    back = _jax_arrays(jeng2)
    for k in ref:
        assert np.array_equal(back[k], ref[k]), k
    assert _lists(jeng2) == _lists(jeng)
    # the loaded JAX engine runs on from the port's file
    jeng2.process_frame(7)
    assert len(jeng2.sections) == 2
