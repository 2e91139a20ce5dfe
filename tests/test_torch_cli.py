"""The port's command line to the contract of `src/vtgaussian_slam.py`, on
the CPU (the kernels' plain versions).

- The smoke config for 3 frames (tracking and mapping cut to 4 iterations
  each, so the run takes seconds on the CPU) writes the config copy,
  `params_ls.npy` (one dict per section, keys / shapes / dtypes as the JAX
  package's `section_to_numpy_params` gives them) and `eval/` (the five
  .txt files and four PNG folders, one row and one file per frame), and
  prints "Final Average ATE RMSE".
- `eval_mode` across packages: the port's `params_ls.npy` re-scored by the
  port's CLI (from the results directory's own config.py copy) and by the
  JAX package's `eval_sequence` at its eval_mode budget; and a
  `params_ls.npy` the JAX package wrote (its `init_section` of smoke frame
  0) re-scored by the port's CLI and by JAX. Per-frame PSNR within 1e-3 dB,
  depth L1 / RMSE, MS-SSIM and LPIPS within 1e-5 relative, the ATE within
  1e-6 m (printed to 0.01 cm, so compared through the returned value).
- Every shipped Replica, TUM, ScanNet and ScanNet++ config runs to its
  end on a 2-frame fixture tree of its format at 24x32 (`--set
  data.basedir=...`, the size, and the fixture's camera YAML or, for
  ScanNet++, the tree's own intrinsics; tracking and mapping cut to 2
  iterations), with use_wandb off but for the first Replica config, which
  keeps it on as shipped and writes `events.jsonl` (an init record, the
  per-iteration tracking and mapping losses, one progress record for
  frame 1 and the Final Stats record).
- `--set` stores Python literals, keeps a bare word only for a new or a
  string entry, and refuses a lower-case boolean or a bare word for a flag
  or a number before anything runs.
"""
import glob
import importlib.util
import os

import numpy as np
import pytest
import torch

from test_torch_eval import _smoke_params_ls
from vtgaussian_slam_tpu.core.pipeline import build_dataset as j_build_dataset
from vtgaussian_slam_tpu.eval import evaluate as JE
from vtgaussian_slam_tpu.eval.lpips import lpips_fn as j_lpips_fn
from vtgaussian_slam_tpu.models import gaussians as JG
from vtgaussian_slam_tpu_torch.__main__ import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "synthetic", "smoke.py")
KEYS = ("means3D", "rgb_colors", "unnorm_rotations", "logit_opacities",
        "log_scales", "cam_unnorm_rots", "cam_trans")
CUT = ["--set", "tracking.num_iters=4", "--set", "tracking.base1_num_iters=4",
       "--set", "mapping.num_iters=4"]


@pytest.fixture(autouse=True, scope="module")
def _first_exp_spent():
    """In a process that also imports JAX, the first multi-threaded
    `torch.exp` on the CPU can come back ~1e-4 off on one thread's share of
    the tensor; later calls are exact. Spend that first call here."""
    torch.exp(torch.randn(1 << 20))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Whole engines and evaluations on the CPU: one intra-op thread, so
    that pytest-xdist's workers (each with torch's default of a thread per
    core) do not oversubscribe the cores; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load_config(path, sets):
    spec = importlib.util.spec_from_file_location("cfg_under_test", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    from vtgaussian_slam_tpu_torch.__main__ import apply_override
    config = module.config
    for item in sets:
        apply_override(config, item)
    return config


@pytest.mark.parametrize("item,path,value", [
    ("workdir=/data/runs/x", ("workdir",), "/data/runs/x"),
    ("data.basedir=./data/Replica", ("data", "basedir"), "./data/Replica"),
    ("data.new_key=room0", ("data", "new_key"), "room0"),
    ("tpu.track_cache=False", ("tpu", "track_cache"), False),
    ("eval_mode=True", ("eval_mode",), True),
    ("tpu.max_pairs_per_tile=2048", ("tpu", "max_pairs_per_tile"), 2048),
    ("workdir='quoted'", ("workdir",), "quoted"),
])
def test_set_override_stores_literals_and_bare_strings(item, path, value):
    config = {"workdir": "./experiments", "eval_mode": False,
              "data": {"basedir": "./data"},
              "tpu": {"track_cache": True, "max_pairs_per_tile": 512}}
    from vtgaussian_slam_tpu_torch.__main__ import apply_override
    apply_override(config, item)
    node = config
    for k in path:
        node = node[k]
    assert node == value and type(node) is type(value)


@pytest.mark.parametrize("item", [
    "tpu.track_cache=false", "eval_mode=false", "tpu.map_binned=true",
    "workdir=none", "data.basedir=Null", "tpu.max_pairs_per_tile=big",
    "eval_mode=yes", "no_equals_sign"])
def test_set_override_refuses_what_is_no_literal(item):
    """A lower-case boolean, or a bare word for a flag or a number, would
    be a truthy string: it raises, and the config keeps its value."""
    config = {"workdir": "./experiments", "eval_mode": False,
              "data": {"basedir": "./data"},
              "tpu": {"track_cache": True, "map_binned": False,
                      "max_pairs_per_tile": 512}}
    from vtgaussian_slam_tpu_torch.__main__ import apply_override
    before = repr(config)
    with pytest.raises(SystemExit):
        apply_override(config, item)
    assert repr(config) == before


def test_cli_refuses_a_lower_case_boolean(tmp_path):
    """`--set tpu.track_cache=false` stops the CLI before any run."""
    with pytest.raises(SystemExit, match="track_cache"):
        main([SMOKE, "--device", "cpu", "--frames", "2", "--set",
              f"workdir={tmp_path}", "--set", "tpu.track_cache=false"])
    assert not os.listdir(tmp_path)


def _txt(d, k):
    return np.atleast_1d(np.loadtxt(os.path.join(d, "eval", f"{k}.txt")))


def _assert_scores_match(port_dir, jax_eval_dir):
    for k in ("psnr", "rmse", "l1", "ssim", "lpips"):
        t = _txt(port_dir, k)
        j = np.atleast_1d(np.loadtxt(os.path.join(jax_eval_dir, f"{k}.txt")))
        assert t.shape == j.shape and np.isfinite(t).all(), (k, t, j)
        if k == "psnr":
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-3)
        else:
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=0)


def _jax_eval_mode(results_dir, config_path, sets, eval_dir):
    """What the JAX CLI's eval_mode branch computes on a results dir."""
    from vtgaussian_slam_tpu.core.config import prepare_config
    config = prepare_config(_load_config(config_path, sets))
    dataset = j_build_dataset(config)
    params_ls = list(np.load(os.path.join(results_dir, "params_ls.npy"),
                             allow_pickle=True))
    color0 = dataset[0][0]
    return JE.eval_sequence(
        dataset, params_ls, len(dataset), eval_dir,
        sil_thres=config["mapping"]["sil_thres"],
        mapping_iters=config["mapping"]["num_iters"],
        add_new_gaussians=config["mapping"]["add_new_gaussians"],
        eval_every=config["eval_every"],
        baseframe_every=config["baseframe_every"], save_frames=True,
        backend_kwargs=JE.eval_backend_kwargs(
            params_ls, color0.shape[0], color0.shape[1], config.get("tpu")),
        lpips_fn=j_lpips_fn())


def _ate_line(out):
    return float(out.split("Final Average ATE RMSE:")[1].split("cm")[0])


def test_smoke_cli_writes_the_contract_and_scores_across_packages(
        tmp_path, capsys):
    sets = ["--set", f"workdir={tmp_path}"] + CUT
    assert main([SMOKE, "--device", "cpu", "--frames", "3", *sets]) == 0
    out = capsys.readouterr().out
    rdir = os.path.join(str(tmp_path), "smoke_3")
    assert "Final Average ATE RMSE" in out and "frame 2:" in out
    assert 0 <= _ate_line(out) < 30.0
    with open(os.path.join(rdir, "config.py")) as f, open(SMOKE) as g:
        assert f.read() == g.read()
    params_ls = np.load(os.path.join(rdir, "params_ls.npy"),
                        allow_pickle=True)
    assert params_ls.dtype == object and len(params_ls) == 1   # bfe 5
    p = params_ls[0]
    assert tuple(sorted(p)) == tuple(sorted(KEYS))
    n = p["means3D"].shape[0]
    assert n > 0 and p["cam_unnorm_rots"].shape == (1, 4, 3)
    # the JAX package loads it and exports the same keys, shapes, dtypes
    sec, traj = JG.section_from_numpy_params(p)
    q = JG.section_to_numpy_params(sec, traj)
    for k in KEYS:
        assert q[k].shape == p[k].shape and q[k].dtype == p[k].dtype, k
        np.testing.assert_array_equal(q[k], p[k])
    for k in ("psnr", "rmse", "l1", "ssim", "lpips"):
        assert _txt(rdir, k).shape == (3,) and np.isfinite(_txt(rdir, k)).all()
    for sub in ("rendered_rgb", "rendered_depth", "rgb", "depth"):
        assert len(os.listdir(os.path.join(rdir, "eval", sub))) == 3
    psnr_train = _txt(rdir, "psnr")

    # eval_mode from the results directory's own config.py (a copy onto
    # itself would raise SameFileError), against JAX's eval_mode scoring
    own = os.path.join(rdir, "config.py")
    assert main([own, "--device", "cpu", "--set", "eval_mode=True",
                 *sets]) == 0
    out = capsys.readouterr().out
    assert "covered prefix" in out        # 11 frames, 3 tracked
    jdir = str(tmp_path / "jax_eval")
    want = _jax_eval_mode(rdir, own, sets[1::2], jdir)
    _assert_scores_match(rdir, jdir)
    assert abs(_ate_line(out) - want["ate_rmse"] * 100) <= 0.0051
    # the generous budget renders at least as deep as the training one
    assert (_txt(rdir, "psnr") >= psnr_train - 1e-3).all()


def test_save_params_writes_the_jax_packages_file(tmp_path):
    """`utils.common.save_params` (which the CLI's params_ls.npy goes
    through) against the JAX package's on the same sections: the same
    bytes, loading to the same dicts, keys, dtypes and values."""
    from torch_port_util import scene_np
    from vtgaussian_slam_tpu.utils.common import save_params as j_save
    from vtgaussian_slam_tpu_torch.utils.common import save_params as t_save
    params_ls = [scene_np(300, 1), scene_np(200, 2)]
    got = t_save(params_ls, str(tmp_path / "port"))
    ref = j_save(params_ls, str(tmp_path / "jax"), name="p.npy")
    assert got == os.path.join(str(tmp_path / "port"), "params_ls.npy")
    with open(got, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()
    a = np.load(got, allow_pickle=True)
    b = np.load(ref, allow_pickle=True)
    assert a.dtype == b.dtype == object and len(a) == len(b) == 2
    for p, q in zip(a, b):
        assert sorted(p) == sorted(q)
        for k in p:
            assert p[k].dtype == q[k].dtype, k
            np.testing.assert_array_equal(p[k], q[k])


def test_jax_written_params_score_the_same_in_the_port(tmp_path, capsys):
    sets = ["--set", f"workdir={tmp_path}", "--set", "eval_every=2"]
    rdir = os.path.join(str(tmp_path), "smoke_3")
    os.makedirs(rdir)
    _, params_ls = _smoke_params_ls()
    np.save(os.path.join(rdir, "params_ls.npy"),
            np.array(params_ls, dtype=object), allow_pickle=True)
    assert main([SMOKE, "--device", "cpu", "--set", "eval_mode=True",
                 *sets]) == 0
    out = capsys.readouterr().out
    jdir = str(tmp_path / "jax_eval")
    want = _jax_eval_mode(rdir, SMOKE, sets[1::2], jdir)
    _assert_scores_match(rdir, jdir)
    assert _txt(rdir, "psnr").shape == (2,)        # frames 0 and 2
    assert abs(_ate_line(out) - want["ate_rmse"] * 100) <= 0.0051
    # and the port's eval_sequence itself, to the metre
    from vtgaussian_slam_tpu_torch.core.pipeline import build_dataset
    from vtgaussian_slam_tpu_torch.eval.evaluate import (eval_backend_kwargs,
                                                         eval_sequence)
    config = _load_config(SMOKE, sets[1::2])
    got = eval_sequence(build_dataset(config), params_ls, 11,
                        str(tmp_path / "port_eval"), eval_every=2,
                        baseframe_every=5, device="cpu",
                        backend_kwargs=eval_backend_kwargs(
                            params_ls, 48, 64, config["tpu"]))
    assert abs(got["ate_rmse"] - want["ate_rmse"]) <= 1e-6


def _shipped(family):
    return sorted(glob.glob(os.path.join(REPO, "configs", family, "*.py")))


def _fixture_tree(root, family, sequence):
    """2 frames of the synthetic scene in the family's file format under
    root/sequence, and a camera YAML of their intrinsics."""
    from test_cli_realdata import (_camera_yaml, _scene_frames,
                                   _write_replica, _write_scannet, _write_tum)
    frames = _scene_frames()[:2]
    writer, scale, fixture_seq = {
        "replica": (_write_replica, 6553.5, "room0"),
        "tum": (_write_tum, 5000.0, "rgbd_dataset_freiburg1_desk"),
        "scannet": (_write_scannet, 1000.0, "scene0000_00")}[family]
    tmp = os.path.join(root, "_tree")
    os.makedirs(tmp)
    writer(tmp, frames, scale)
    os.rename(os.path.join(tmp, fixture_seq), os.path.join(root, sequence))
    yml = os.path.join(root, "cam.yaml")
    _camera_yaml(yml, frames[0][2], scale, family)
    return yml


def _scannetpp_tree(root, sequence):
    """tests/test_torch_datasets.py's ScanNet++ tree (6 random frames, the
    first 4 the train split) under root/sequence."""
    from test_torch_datasets import _scannetpp
    _, fixture_seq, _ = _scannetpp(root, np.random.default_rng(0), True,
                                   False)
    os.rename(os.path.join(root, fixture_seq), os.path.join(root, sequence))


@pytest.mark.parametrize("path", _shipped("replica") + _shipped("tum")
                         + _shipped("scannet") + _shipped("scannetpp"),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_shipped_real_data_config_runs_on_a_fixture_tree(tmp_path, path,
                                                         capsys, monkeypatch):
    pytest.importorskip("cv2")
    monkeypatch.chdir(REPO)
    family = os.path.basename(os.path.dirname(path))
    sequence = os.path.basename(
        str(_load_config(path, [])["data"]["sequence"]))
    data = str(tmp_path / "data")
    os.makedirs(data)
    wandb = path == _shipped("replica")[0]
    if family == "scannetpp":
        _scannetpp_tree(data, sequence)
        tree = ["data.num_frames=2"]
    else:
        tree = [f"data.gradslam_data_cfg={_fixture_tree(data, family, sequence)}"]
    sets = [f"workdir={tmp_path / 'exp'}", f"data.basedir={data}", *tree,
            f"use_wandb={wandb}",
            "data.desired_image_height=24", "data.desired_image_width=32",
            "data.densification_image_height=48",
            "data.densification_image_width=64", "eval_every=1",
            "tracking.num_iters=2", "tracking.base1_num_iters=2",
            "mapping.num_iters=2"]
    argv = [path, "--device", "cpu"]
    for s in sets:
        argv += ["--set", s]
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "frame 1:" in out and "Final Average ATE RMSE" in out
    rdirs = glob.glob(str(tmp_path / "exp" / "*" / "params_ls.npy"))
    assert len(rdirs) == 1
    rdir = os.path.dirname(rdirs[0])
    psnr = _txt(rdir, "psnr")
    assert psnr.shape == (2,) and np.isfinite(psnr).all()
    events = os.path.join(rdir, "events.jsonl")
    assert os.path.exists(events) == wandb
    if wandb:
        import json
        recs = [json.loads(x) for x in open(events).read().splitlines()]
        n = lambda key: sum(1 for r in recs if key in r)
        assert recs[0]["event"] == "init"
        assert n("Per Iteration Tracking/Loss") == 2       # frame 1
        assert n("Per Iteration Mapping/Loss") == 4        # frames 0, 1
        assert n("Tracking/PSNR") == 1 and n("Final Stats/step") == 1
