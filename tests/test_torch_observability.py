"""The port's use_wandb event stream and progress reports against the JAX
package's.

- `RunLogger` (JSONL, wandb being absent) writes records with the JAX
  package's names for the same calls.
- `frame_quality` matches JAX's within 1e-6 (PSNR in dB, depth "RMSE" /
  L1 in metres) on a render with a partial silhouette and depth holes, and
  its mask exactly.
- A run of the smoke config at 24 x 32 with use_wandb on and a progress
  report every frame: the port's `events.jsonl` holds the same record
  kinds (the set of keys of a record) with the same counts as the JAX
  engine's, and a `plots/` panel per reported frame; with matplotlib
  hidden (its import monkeypatched to fail), one printed note, the same
  records, no panel and no emergency params*.npz.
"""
import builtins
import collections
import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import one_thread, smoke_config  # noqa: F401
from vtgaussian_slam_tpu.core import losses as JL
from vtgaussian_slam_tpu.core.pipeline import VTGaussianSLAM as JEngine
from vtgaussian_slam_tpu.utils import observability as JO
from vtgaussian_slam_tpu_torch.core import losses as TL
from vtgaussian_slam_tpu_torch.core.pipeline import VTGaussianSLAM as TEngine
from vtgaussian_slam_tpu_torch.utils import observability as TO

FRAMES = 4


def _records(path):
    return [json.loads(line) for line in open(path).read().splitlines()]


def _kinds(records):
    return collections.Counter(
        tuple(sorted(k for k in r if k != "t")) for r in records)


def _log_calls(mod, out_dir):
    lg = mod.RunLogger(True, project="p", group="g", name="n",
                       out_dir=str(out_dir))
    step = 0
    for kw in (dict(tracking=True), dict(mapping=True), {}):
        step = mod.report_loss({"loss": 1.5, "im": 1.0, "depth": 0.5}, lg,
                               step, **kw)
    mod.report_progress(lg, 3, np.eye(4), [np.eye(4)] * 5, psnr=20.0,
                        depth_rmse=0.1)
    mod.report_progress(lg, 4, np.eye(4), [np.eye(4)] * 5)
    lg.log({"Final Stats/step": 1})
    lg.finish()
    return step, _records(os.path.join(str(out_dir), "events.jsonl"))


def test_run_logger_records_match(tmp_path):
    ts, trec = _log_calls(TO, tmp_path / "port")
    js, jrec = _log_calls(JO, tmp_path / "jax")
    assert ts == js == 3
    assert [sorted(r) for r in trec] == [sorted(r) for r in jrec]
    for a, b in zip(trec, jrec):
        assert {k: v for k, v in a.items() if k != "t"} == \
            {k: v for k, v in b.items() if k != "t"}
    off = TO.RunLogger(False, out_dir=str(tmp_path / "off"))
    off.log({"x": 1})
    off.finish()
    assert not (tmp_path / "off").exists()


def test_frame_quality_matches():
    rng = np.random.default_rng(0)
    H, W = 24, 32
    im = rng.uniform(-0.1, 1.1, (3, H, W)).astype(np.float32)
    depth = rng.uniform(1.0, 3.0, (1, H, W)).astype(np.float32)
    sil = rng.uniform(0, 1, (H, W)).astype(np.float32)
    gt_im = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    gt_depth = rng.uniform(1.0, 3.0, (1, H, W)).astype(np.float32)
    gt_depth[0, rng.uniform(size=(H, W)) < 0.2] = 0.0
    out = {}
    for name, L, conv in (("jax", JL, jnp.asarray), ("port", TL,
                                                    torch.as_tensor)):
        r = L.RenderResult(im=conv(im), depth=conv(depth),
                           silhouette=conv(sil), depth_sq=conv(depth * depth),
                           radii=conv(np.ones(4, np.float32)))
        f = L.Frame(color=conv(gt_im), depth=conv(gt_depth))
        mod = JO if name == "jax" else TO
        out[name] = mod.frame_quality(r, f, 0.4)
    (jp, jr, jl, jm), (tp, tr, tl, tm) = out["jax"], out["port"]
    assert all(isinstance(x, float) for x in (tp, tr, tl))
    assert abs(tp - jp) <= 1e-6 and abs(tr - jr) <= 1e-6 \
        and abs(tl - jl) <= 1e-6, ((tp, tr, tl), (jp, jr, jl))
    assert tr == tl      # the reference's elementwise-sqrt "RMSE"
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def _smoke(workdir):
    return smoke_config(workdir, frames=FRAMES, use_wandb=True,
                        report_global_progress_every=1, baseframe_every=2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("obs")
    jcfg = _smoke(root / "jax")
    JEngine(jcfg).run(progress=False)
    port = TEngine(_smoke(root / "port"), device="cpu").run()
    run = lambda c: os.path.join(c["workdir"], c["run_name"])
    return run(jcfg), run(port.config), port


def test_engine_event_stream_matches_jax(runs):
    jdir, tdir, port = runs
    jk = _kinds(_records(os.path.join(jdir, "events.jsonl")))
    tk = _kinds(_records(os.path.join(tdir, "events.jsonl")))
    assert tk == jk
    prog = [k for k in tk if "Tracking/PSNR" in k]
    assert prog and tk[prog[0]] == FRAMES - 1       # frames 1 .. 3
    track = [k for k in tk if "Per Iteration Tracking/Loss" in k]
    assert tk[track[0]] == sum(1 for _ in range(1, FRAMES)) * 3
    assert sorted(os.listdir(os.path.join(tdir, "plots"))) == [
        f"frame_{t:05d}.png" for t in range(1, FRAMES)]
    assert "t_progress" in port.frame_times[1]["timers"]


def test_no_matplotlib_skips_panels_with_one_note(tmp_path, monkeypatch,
                                                  capsys):
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kw):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError("no matplotlib here")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    cfg = _smoke(tmp_path)
    eng = TEngine(cfg, device="cpu").run()
    out = capsys.readouterr().out
    assert out.count("no matplotlib: panels skipped") == 1
    rdir = os.path.join(cfg["workdir"], cfg["run_name"])
    assert not os.path.exists(os.path.join(rdir, "plots"))
    assert glob.glob(os.path.join(rdir, "params*.npz")) == []
    assert "Failed to evaluate trajectory" not in out
    kinds = _kinds(_records(os.path.join(rdir, "events.jsonl")))
    assert sum(n for k, n in kinds.items() if "Tracking/PSNR" in k) == \
        FRAMES - 1
    assert eng.stats["t_progress"] > 0
