"""The port's data layer against the JAX package's, on fixture trees.

Every loader reads a miniature dataset tree in its own file format,
written here (the Replica, TUM and ScanNet trees by the writers of
`tests/test_cli_realdata.py`), and both packages' `(color, depth, K,
pose)` must be equal to the bit, with start / end / stride and a desired
size that resizes. Also: `dataconfig`'s `inherit_from` merge and its cycle
error, `FramePrefetcher`, and the engine's reads through its prefetchers
against reads of the bare datasets.
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from test_cli_realdata import (_scene_frames, _write_replica,  # noqa: E402
                               _write_scannet, _write_tum)
from vtgaussian_slam_tpu import datasets as JD  # noqa: E402
from vtgaussian_slam_tpu.datasets.dataconfig import \
    load_dataset_config as j_load_cfg  # noqa: E402
from vtgaussian_slam_tpu_torch import datasets as TD  # noqa: E402
from vtgaussian_slam_tpu_torch.datasets.dataconfig import \
    load_dataset_config as t_load_cfg  # noqa: E402
from vtgaussian_slam_tpu_torch.datasets.prefetch import \
    FramePrefetcher  # noqa: E402

H, W = 24, 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Whole engines and evaluations on the CPU: one intra-op thread, so
    that pytest-xdist's workers (each with torch's default of a thread per
    core) do not oversubscribe the cores; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cam(name, scale=1000.0, H=H, W=W, **extra):
    return {"dataset_name": name,
            "camera_params": dict(image_height=H, image_width=W, fx=30.0,
                                  fy=31.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5,
                                  png_depth_scale=scale, crop_edge=0,
                                  **extra)}


def _img(rng):
    return rng.integers(0, 256, (H, W, 3), dtype=np.uint8)


def _dep(rng, scale=1000.0):
    d = rng.uniform(0.5, 4.0, (H, W))
    d[rng.uniform(size=(H, W)) < 0.05] = 0.0
    return (d * scale).astype(np.uint16)


def _pose(rng):
    from scipy.spatial.transform import Rotation
    T = np.eye(4)
    T[:3, :3] = Rotation.from_rotvec(rng.normal(0, 0.2, 3)).as_matrix()
    T[:3, 3] = rng.normal(0, 1, 3)
    return T


def _rows(T):
    return " ".join(f"{v:.12f}" for v in np.asarray(T).reshape(-1))


# -- fixture trees: each returns (config_dict or None, sequence, kwargs) ---
def tree_replica(root, rng):
    _write_replica(root, _scene_frames())
    return _cam("replica", 6553.5, H=48, W=64), "room0", {}


def tree_tum(root, rng):
    _write_tum(root, _scene_frames())
    return _cam("tum", 5000.0, H=48, W=64), "rgbd_dataset_freiburg1_desk", {}


def tree_scannet(root, rng):
    _write_scannet(root, _scene_frames())
    return _cam("scannet", 1000.0, H=48, W=64), "scene0000_00", {}


def _replica_v2_split(root, split, n, rng):
    seq = os.path.join(root, "room_0", split)
    os.makedirs(os.path.join(seq, "rgb"))
    os.makedirs(os.path.join(seq, "depth"))
    with open(os.path.join(seq, "traj_w_c.txt"), "w") as f:
        for i in range(n):
            cv2.imwrite(os.path.join(seq, "rgb", f"rgb_{i}.png"), _img(rng))
            cv2.imwrite(os.path.join(seq, "depth", f"depth_{i}.png"),
                        _dep(rng))
            f.write(_rows(_pose(rng)) + "\n")


def tree_replicav2_train(root, rng):
    _replica_v2_split(root, "imap/00", 5, rng)
    return _cam("replicav2"), "room_0", {"use_train_split": True}


def tree_replicav2_test(root, rng):
    _replica_v2_split(root, "imap/00", 3, rng)
    _replica_v2_split(root, "imap/01", 4, rng)
    return _cam("replicav2"), "room_0", {"use_train_split": False}


def _scannetpp(root, rng, use_train_split, ignore_bad):
    base = os.path.join(root, "2e67a32314", "dslr")
    for sub in ("undistorted_images", "undistorted_depths", "nerfstudio"):
        os.makedirs(os.path.join(base, sub))
    names = [f"DSC{i:05d}.JPG" for i in range(6)]
    frames = []
    for i, name in enumerate(names):
        cv2.imwrite(os.path.join(base, "undistorted_images", name), _img(rng))
        cv2.imwrite(os.path.join(base, "undistorted_depths",
                                 name.replace(".JPG", ".png")), _dep(rng))
        frames.append({"file_path": name, "is_bad": i == 2,
                       "transform_matrix": _pose(rng).tolist()})
    meta = {"h": H, "w": W, "fl_x": 30.0, "fl_y": 31.0, "cx": 15.5,
            "cy": 11.5, "frames": frames[:4], "test_frames": frames[4:]}
    with open(os.path.join(base, "nerfstudio",
                           "transforms_undistorted.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(base, "train_test_lists.json"), "w") as f:
        json.dump({"train": names[:4], "test": names[4:]}, f)
    return ({"dataset_name": "scannetpp"}, "2e67a32314",
            {"use_train_split": use_train_split, "ignore_bad": ignore_bad})


def tree_scannetpp_train(root, rng):
    return _scannetpp(root, rng, True, True)


def tree_scannetpp_test(root, rng):
    return _scannetpp(root, rng, False, False)


def _color_depth_dirs(seq, n, rng, cdir, ddir, cext, name=lambda i: f"{i}"):
    os.makedirs(os.path.join(seq, cdir))
    os.makedirs(os.path.join(seq, ddir))
    for i in range(n):
        cv2.imwrite(os.path.join(seq, cdir, f"{name(i)}.{cext}"), _img(rng))
        cv2.imwrite(os.path.join(seq, ddir, f"{name(i)}.png"), _dep(rng))


def tree_icl_sim(root, rng):
    seq = os.path.join(root, "living_room")
    _color_depth_dirs(seq, 5, rng, "rgb", "depth", "png")
    rows = []
    for _ in range(5):
        T = _pose(rng)
        rows += [" ".join(f"{v:.12f}" for v in T[r]) for r in range(3)]
    with open(os.path.join(seq, "lr.gt.sim"), "w") as f:
        f.write("\n".join(rows) + "\n")
    return _cam("icl"), "living_room", {}


def tree_icl_freiburg(root, rng):
    from scipy.spatial.transform import Rotation
    seq = os.path.join(root, "living_room")
    _color_depth_dirs(seq, 5, rng, "rgb", "depth", "png")
    with open(os.path.join(seq, "lr.gt.freiburg"), "w") as f:
        for i in range(5):
            T = _pose(rng)
            q = Rotation.from_matrix(T[:3, :3]).as_quat()
            f.write(f"{i} " + " ".join(f"{v:.12f}" for v in
                                       list(T[:3, 3]) + list(q)) + "\n")
    return _cam("icl"), "living_room", {}


def tree_azure_log(root, rng):
    seq = os.path.join(root, "capture")
    _color_depth_dirs(seq, 5, rng, "color", "depth", "jpg",
                      name=lambda i: f"{i:05d}")
    lines = []
    for i in range(5):
        lines.append(f"{i} {i} {i + 1}")
        lines += [" ".join(f"{v:.12f}" for v in _pose(rng)[r])
                  for r in range(4)]
    with open(os.path.join(seq, "odom.log"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return _cam("azure"), "capture", {"odomfile": "odom.log"}


def tree_azure_dvo(root, rng):
    seq = os.path.join(root, "capture")
    _color_depth_dirs(seq, 5, rng, "color", "depth", "jpg",
                      name=lambda i: f"{i:05d}")
    with open(os.path.join(seq, "poses_global_dvo.txt"), "w") as f:
        f.write("\n".join(_rows(_pose(rng)) for _ in range(5)) + "\n")
    return _cam("azurekinect"), "capture", {}


def tree_azure_none(root, rng):
    seq = os.path.join(root, "capture")
    _color_depth_dirs(seq, 5, rng, "color", "depth", "jpg",
                      name=lambda i: f"{i:05d}")
    return _cam("azure"), "capture", {}


def tree_ai2thor(root, rng):
    seq = os.path.join(root, "FloorPlan1")
    _color_depth_dirs(seq, 5, rng, "color", "depth", "png")
    os.makedirs(os.path.join(seq, "pose"))
    for i in range(5):
        np.savetxt(os.path.join(seq, "pose", f"{i}.txt"), _pose(rng))
    return _cam("ai2thor"), "FloorPlan1", {}


def _poses_npy(seq, n, rng):
    os.makedirs(os.path.join(seq, "poses"))
    for i in range(n):
        np.save(os.path.join(seq, "poses", f"{i}.npy"), _pose(rng))


def tree_record3d(root, rng):
    seq = os.path.join(root, "scan")
    _color_depth_dirs(seq, 5, rng, "rgb", "depth", "png")
    _poses_npy(seq, 5, rng)
    return _cam("record3d"), "scan", {}


def tree_realsense(root, rng):
    seq = os.path.join(root, "scan")
    _color_depth_dirs(seq, 5, rng, "rgb", "depth", "jpg")
    _poses_npy(seq, 5, rng)
    return _cam("realsense"), "scan", {}


def tree_nerfcapture(root, rng):
    seq = os.path.join(root, "capture")
    os.makedirs(os.path.join(seq, "rgb"))
    os.makedirs(os.path.join(seq, "depth"))
    frames = []
    for i in range(5):
        cv2.imwrite(os.path.join(seq, "rgb", f"{i}.png"), _img(rng))
        cv2.imwrite(os.path.join(seq, "depth", f"{i}.png"), _dep(rng, 6553.5))
        frames.append({"file_path": f"rgb/{i}.png",
                       "transform_matrix": _pose(rng).tolist()})
    with open(os.path.join(seq, "transforms.json"), "w") as f:
        json.dump({"h": H, "w": W, "fl_x": 30.0, "fl_y": 31.0, "cx": 15.5,
                   "cy": 11.5, "frames": frames}, f)
    return {"dataset_name": "nerfcapture"}, "capture", {}


def tree_kitti(root, rng):
    seq = os.path.join(root, "00")
    _color_depth_dirs(seq, 5, rng, "rgb", "depth", "png",
                      name=lambda i: f"{i:06d}")
    with open(os.path.join(seq, "poses.txt"), "w") as f:
        f.write("\n".join(" ".join(f"{v:.12f}" for v in _pose(rng)[:3]
                                   .reshape(-1)) for _ in range(5)) + "\n")
    return _cam("kitti"), "00", {}


TREES = {k[len("tree_"):]: v for k, v in dict(globals()).items()
         if k.startswith("tree_")}
WINDOWS = [dict(), dict(start=1, end=-1, stride=2),
           dict(start=0, end=4, stride=1)]


def _frames_equal(jds, tds):
    assert len(jds) == len(tds) > 0
    np.testing.assert_array_equal(np.asarray(tds.poses), np.asarray(jds.poses))
    for i in range(len(jds)):
        for a, b in zip(jds[i], tds[i]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("window", range(len(WINDOWS)))
@pytest.mark.parametrize("tree", sorted(TREES))
def test_loader_bit_identical_to_jax(tmp_path, tree, window):
    rng = np.random.default_rng(sorted(TREES).index(tree))
    cfg, seq, kw = TREES[tree](str(tmp_path), rng)
    kw = dict(kw, desired_height=12, desired_width=20, **WINDOWS[window])
    if window == 2:
        kw.update(desired_height=30, desired_width=36)     # upsampling
    if tree == "kitti":     # no factory entry, on either side
        jds = JD.KittiDataset(cfg, str(tmp_path), seq, **kw)
        tds = TD.KittiDataset(cfg, str(tmp_path), seq, **kw)
    else:
        jds = JD.get_dataset(cfg, str(tmp_path), seq, **kw)
        tds = TD.get_dataset(cfg, str(tmp_path), seq, **kw)
    assert type(tds).__name__ == type(jds).__name__
    _frames_equal(jds, tds)


def test_undistortion_bit_identical(tmp_path):
    rng = np.random.default_rng(9)
    cfg, seq, _ = tree_ai2thor(str(tmp_path), rng)
    cfg["camera_params"]["distortion"] = [0.1, -0.05, 0.001, 0.002, 0.0]
    kw = dict(desired_height=18, desired_width=24)
    _frames_equal(JD.get_dataset(cfg, str(tmp_path), seq, **kw),
                  TD.get_dataset(cfg, str(tmp_path), seq, **kw))


def test_unknown_name_and_bad_windows():
    with pytest.raises(ValueError, match="Unknown dataset"):
        TD.get_dataset({"dataset_name": "nope"}, "", "")
    for bad in (dict(start=-1), dict(start=3, end=2)):
        with pytest.raises(ValueError):
            TD.get_dataset(_cam("replica"), "/nonexistent", "x", **bad)


def test_dataconfig_inherit_from_and_cycle(tmp_path):
    base = tmp_path / "base.yaml"
    base.write_text("dataset_name: 'replica'\ncamera_params:\n  fx: 600.0\n"
                    "  fy: 600.0\n  crop_edge: 0\n")
    mid = tmp_path / "mid.yaml"
    mid.write_text(f"inherit_from: {base}\ncamera_params:\n  fy: 500.0\n")
    child = tmp_path / "child.yaml"
    child.write_text(f"inherit_from: {mid}\ncamera_params:\n  fx: 300.0\n")
    got, want = t_load_cfg(str(child)), j_load_cfg(str(child))
    assert got == want
    assert got["camera_params"] == {"fx": 300.0, "fy": 500.0, "crop_edge": 0}
    default = tmp_path / "default.yaml"
    default.write_text("dataset_name: 'tum'\nextra: 1\n")
    lone = tmp_path / "lone.yaml"
    lone.write_text("camera_params:\n  fx: 1.0\n")
    assert t_load_cfg(str(lone), str(default)) == \
        j_load_cfg(str(lone), str(default))
    a, b = tmp_path / "a.yaml", tmp_path / "b.yaml"
    a.write_text(f"inherit_from: {b}\nx: 1\n")
    b.write_text(f"inherit_from: {a}\ny: 2\n")
    with pytest.raises(ValueError, match="inherit_from cycle"):
        t_load_cfg(str(a))
    (tmp_path / "empty.yaml").write_text("")
    with pytest.raises(ValueError, match="empty"):
        t_load_cfg(str(tmp_path / "empty.yaml"))
    for shipped in ("replica", "replica_v2", "scannet", "TUM/freiburg1_desk"):
        path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                            "configs", "data", f"{shipped}.yaml")
        assert t_load_cfg(path) == j_load_cfg(path)


class _Counting:
    """A dataset whose reads are counted, with poses."""

    def __init__(self, n=12):
        self.poses = np.arange(n * 16, dtype=np.float64).reshape(n, 4, 4)
        self.reads = []
        self.lock = threading.Lock()

    def __len__(self):
        return len(self.poses)

    def __getitem__(self, i):
        with self.lock:
            self.reads.append(i)
        return (np.full((2, 3, 3), i, np.float32), self.poses[i])


def test_frame_prefetcher_returns_frames_and_forwards_attributes():
    ds = _Counting()
    pf = FramePrefetcher(ds, lookahead=2)
    try:
        assert len(pf) == len(ds)
        assert pf.poses is ds.poses
        for i in range(len(ds)):
            a, p = pf[i]
            assert (a == i).all() and (p == ds.poses[i]).all()
        pf[3]                       # a far read between sequential ones
        assert (pf[11][0] == 11).all()
        with pytest.raises(AttributeError):
            pf._missing
    finally:
        pf.close()
    assert set(ds.reads) == set(range(len(ds)))


def test_frame_prefetcher_under_concurrent_readers():
    """More reading threads than cores, a short switch interval: every read
    returns its own index's frame."""
    import sys
    ds = _Counting(40)
    pf = FramePrefetcher(ds, lookahead=3, workers=3, cache_size=4)
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def reader(seed):
            rng = np.random.default_rng(seed)
            try:
                for i in rng.integers(0, 40, 60):
                    if not (pf[int(i)][0] == i).all():
                        errors.append(int(i))
            except Exception as e:      # reported by the assert below
                errors.append(repr(e))
        threads = [threading.Thread(target=reader, args=(s,))
                   for s in range(2 * (os.cpu_count() or 2))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
        pf.close()
    assert not errors


def _engine_config(workdir):
    from test_torch_slice import _config
    cfg = _config(workdir)
    cfg["baseframe_every"] = 3
    cfg["tracking"]["num_iters"] = cfg["tracking"]["base1_num_iters"] = 2
    cfg["mapping"]["num_iters"] = 2
    return cfg


def test_engine_streams_read_through_prefetchers(tmp_path):
    """Both of the engine's frame streams are prefetchers at the config's
    lookahead, giving `build_dataset`'s frames; `_stage` puts them on the
    device as float32 CHW tensors, colour in [0, 1]."""
    from vtgaussian_slam_tpu_torch.core.pipeline import (VTGaussianSLAM,
                                                         build_dataset)
    cfg = _engine_config(tmp_path)
    cfg["tpu"]["prefetch"] = 3
    eng = VTGaussianSLAM(cfg, device="cpu")
    try:
        assert eng.sep_densify
        for stream, densify_res in ((eng.dataset, False),
                                    (eng.densify_dataset, True)):
            assert isinstance(stream, FramePrefetcher)
            assert stream._lookahead == 3
            bare = build_dataset(cfg, densify_res=densify_res)
            assert len(stream) == len(bare)
            np.testing.assert_array_equal(stream.poses, bare.poses)
            for t in (4, 1, 2):
                for a, b in zip(stream[t], bare[t]):
                    np.testing.assert_array_equal(a, b)
        color, depth = eng.dataset[2][:2]
        f = eng._stage(color, depth)
        want_c = torch.as_tensor(np.asarray(color, np.float32)).permute(
            2, 0, 1) / 255.0
        want_d = torch.as_tensor(np.asarray(depth, np.float32)).permute(
            2, 0, 1)
        assert f.color.dtype == f.depth.dtype == torch.float32
        assert torch.equal(f.color, want_c) and torch.equal(f.depth, want_d)
    finally:
        eng.close()


class _Bare:
    """A dataset read directly, in the prefetcher's place."""

    def __init__(self, dataset, lookahead=2):
        self._ds = dataset

    def __len__(self):
        return len(self._ds)

    def __getitem__(self, idx):
        return self._ds[idx]

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._ds, name)

    def close(self):
        pass


def test_results_do_not_depend_on_prefetch(tmp_path, monkeypatch):
    """Frames 0-4 across a boundary read through the prefetchers, and with
    the datasets read directly: the same bits."""
    from vtgaussian_slam_tpu_torch.core import pipeline as TP
    runs = []
    for wrapper in (FramePrefetcher, _Bare):
        monkeypatch.setattr(TP, "FramePrefetcher", wrapper)
        torch.manual_seed(0)
        eng = TP.VTGaussianSLAM(_engine_config(tmp_path), device="cpu")
        try:
            assert isinstance(eng.densify_dataset, wrapper)
            eng.run(5)
            runs.append((eng.traj.quats.clone(), eng.traj.trans.clone(),
                         [s.params.tensors() for s in eng.sections]))
        finally:
            eng.close()
    (q0, t0, s0), (q1, t1, s1) = runs
    assert torch.equal(q0, q1) and torch.equal(t0, t1)
    assert len(s0) == len(s1) == 2
    for a, b in zip(s0, s1):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
