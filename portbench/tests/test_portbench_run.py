"""Whole runs of a tiny cell on the CPU (the port's plain versions of the
kernels): the harness's look for a card skipped, the rest of a run as on
the card. A sound run comes out correct; each fault planted in the timed
path underneath makes `correct` false; a cell, a mix and a metric added as
new files run without an edit to any file that was there."""
import hashlib
import json
import os
import shutil

import pytest
import torch

from portbench.harness.spec import BENCH, ROOT
from portbench.tests.tiny import run_tiny
from vtgaussian_slam_tpu_torch.core import (losses, map_cache, mapping,
                                            pipeline, tracking)
from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_splat


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def failing(result) -> list:
    """The numbers over their limits (of a run's result, or of its
    control's)."""
    return sorted(k for k, c in result["check"].items()
                  if c["value"] is None or not c["value"] <= c["limit"])


@pytest.mark.parametrize("cell", ["room0.scan", "fr1.desk"])
def test_a_sound_run_is_correct(cell, cell_root, tmp_path):
    r = run_tiny(cell, tmp_path, root=cell_root)
    assert r["correct"], r["check"]
    assert r["attempted"] >= 2 and r["failed"] == 0
    assert set(r["metrics"]) == {"frames_per_s", "frame_s_p95",
                                 "peak_mem_gib", "setup_s"}
    assert list(r)[-1] == "check"


@pytest.mark.parametrize("cell", ["room0.scan", "fr1.desk"])
def test_the_control_fails_the_limits(cell, cell_root, tmp_path):
    """The reference in TF32, put in the program's place, is judged by the
    run's own comparison and comes out not correct."""
    r = run_tiny(cell, tmp_path, root=cell_root, readings=True)
    assert r["correct"]
    assert r["control"]["correct"] is False, r["control"]
    assert failing(r["control"]), r["control"]


def _unchanged_track_state(render_fn, state, frame, aux, cfg, *a, **k):
    return state, None, None


def _unchanged_map_step(params, grads, state, lrs, **k):
    return list(params), state


def _half_batch(real):
    def loss(r, frame, cfg, *a, **k):
        h = frame.depth.shape[-2] // 2
        r2 = losses.RenderResult(im=r.im[:, :h], depth=r.depth[:, :h],
                                 silhouette=r.silhouette[:h],
                                 depth_sq=r.depth_sq[:, :h], radii=r.radii)
        f2 = losses.Frame(color=frame.color[:, :h], depth=frame.depth[:, :h])
        out = real(r2, f2, cfg, *a, **k)
        if not cfg.tracking:      # mapping's losses are means already
            return out
        return out._replace(loss=2 * out.loss, im_loss=2 * out.im_loss,
                            depth_loss=2 * out.depth_loss)
    return loss


def _scaled_pose_grad(real):
    def k2(*a, **k):
        return real(*a, **k) * 1.5
    return k2


def _row_dropped(real):
    """A binning that loses the last row of every tile where it is built."""
    def build(*a, **k):
        c = real(*a, **k)
        return c._replace(counts=torch.clamp(c.counts - 1, min=0))
    return build


def _moved_points(real):
    def dens(*a, **k):
        c = real(*a, **k)
        return c._replace(points=c.points + 1e-2)
    return dens


FAULTS = {
    "tracking step returns its state": (
        lambda mp: mp.setattr(tracking, "track_loop", _unchanged_track_state),
        {"track_loss", "track_change"}),
    "mapping step returns its state": (
        lambda mp: mp.setattr(mapping, "adam_step", _unchanged_map_step),
        {"map_change"}),
    "half of the pixels left out, the mean over the rest": (
        lambda mp: (mp.setattr(tracking, "loss_from_render",
                               _half_batch(losses.loss_from_render)),
                    mp.setattr(mapping, "loss_from_render",
                               _half_batch(losses.loss_from_render))),
        {"track_loss", "map_loss"}),
    "pose gradient altered where K2 produces it": (
        lambda mp: mp.setattr(cuda_splat, "splat_backward_pose",
                              _scaled_pose_grad(cuda_splat.splat_backward_pose)),
        {"track_grad"}),
    "keyframe binning loses a row where it is built": (
        lambda mp: mp.setattr(map_cache, "build_kf_cache",
                              _row_dropped(map_cache.build_kf_cache)),
        {"map_tables"}),
    "global binning loses a row where it is built": (
        lambda mp: mp.setattr(pipeline, "build_global_cache",
                              _row_dropped(pipeline.build_global_cache)),
        {"global_tables"}),
    "densified points moved where they are produced": (
        lambda mp: mp.setattr(pipeline, "densify_from_pixels",
                              _moved_points(pipeline.densify_from_pixels)),
        {"densify_rows"}),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_makes_the_run_incorrect(fault, tmp_path, monkeypatch):
    plant, numbers = FAULTS[fault]
    plant(monkeypatch)
    r = run_tiny("room0.scan", tmp_path)
    assert not r["correct"]
    assert numbers & set(failing(r)), (fault, r["check"])


def _digest(root):
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = hashlib.sha1(
                open(p, "rb").read()).hexdigest()
    return out


def test_added_cell_mix_and_metric_need_no_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = _digest(root / "portbench")
    pb = root / "portbench"
    mix = json.loads((pb / "traffic" / "handheld.json").read_text())
    mix.update(name="handheld_fast", trans_m_per_frame=0.03)
    (pb / "traffic" / "handheld_fast.json").write_text(json.dumps(mix))
    (pb / "metrics" / "frames_seen.py").write_text(
        "def read(run):\n    return float(len(run.frames))\n")
    shutil.copy(pb / "limits" / "room0.scan.json",
                pb / "limits" / "room0.fast.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "room0.fast", "config": "replica-room0",
                               "traffic": "handheld_fast", "chips": 1,
                               "why": "a faster handheld walk"})
    bench["per_layer"].append({"name": "frames_seen", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "frame", "moves": "frames_per_s",
                               "workloads": ["room0.fast"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run_tiny("room0.fast", tmp_path / "cache", root=str(root), trace=True,
                 min_frames=3)
    assert r["metrics"]["frames_seen"]["value"] >= 3
    assert {"track_s", "map_s", "load_s"} <= set(r["metrics"])
    after = _digest(root / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.cuda
def test_one_cell_runs_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import subprocess
    import sys
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "room0.scan",
         "--seed", "77", "--seconds", "4", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
