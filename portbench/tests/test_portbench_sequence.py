"""The generator's files, read back through the port's own loaders."""
import json
import os

import numpy as np
import pytest
import torch

from portbench.harness import imageio_shim
from portbench.harness.check import Sequence
from portbench.harness.sequence import trajectory, write_sequence
from portbench.harness.spec import load_cell
from portbench.tests.tiny import tiny_cell


@pytest.mark.parametrize("cell", ["room0.scan", "fr1.desk"])
def test_motion_per_frame_is_the_mix_s_whatever_the_path(cell, cell_root):
    tr = (load_cell(cell, cell_root) if cell_root else load_cell(cell)).traffic
    for path_seed in (0, 3, 2**31 + 11):
        P = trajectory(dict(tr, path_seed=path_seed))
        step = np.linalg.norm(np.diff(P[:, :3, 3], axis=0), axis=1)
        np.testing.assert_allclose(step, tr["trans_m_per_frame"], rtol=1e-3)
        ang = [np.degrees(np.arccos(np.clip(
            (np.trace(P[i, :3, :3].T @ P[i + 1, :3, :3]) - 1) / 2, -1, 1)))
            for i in range(len(P) - 1)]
        assert abs(np.mean(ang) - tr["rot_deg_per_frame"]) < 1e-3 * \
            tr["rot_deg_per_frame"]
        room = np.asarray(tr["room_size"])
        assert (P[:, :3, 3] > 0.5).all() and (P[:, :3, 3] < room - 0.5).all()


@pytest.mark.parametrize("cell", ["room0.scan", "fr1.desk"])
def test_port_loaders_read_the_sequence_frame_for_frame(cell, cell_root,
                                                       tmp_path):
    from vtgaussian_slam_tpu_torch.datasets import get_dataset
    c = tiny_cell(cell, cell_root)
    c.traffic["frames"] = 6
    fmt, cam = c.config["format"], c.config["camera"]
    out = str(tmp_path / "seq")
    info = write_sequence(out, fmt, cam, c.traffic, 5, "cpu", threads=2)
    assert info["frames"] == 6 and info["bytes"] > 0
    imageio_shim.install()
    with open(os.path.join(out, "camera.yaml")) as f:
        gcfg = json.load(f)
    ds = get_dataset(gcfg, str(tmp_path), "seq",
                     desired_height=cam["image_height"],
                     desired_width=cam["image_width"])
    assert len(ds) == 6
    poses = trajectory(c.traffic)
    rel = np.linalg.inv(poses[0]) @ poses
    seq = Sequence(out, fmt, cam)
    for i in range(6):
        color, depth, K, pose = ds[i]
        c_ref, d_ref = seq.read(i, cam["image_height"], cam["image_width"])
        np.testing.assert_array_equal(color, c_ref)
        np.testing.assert_array_equal(depth[..., 0], d_ref)
        np.testing.assert_allclose(pose, rel[i], atol=2e-6)
        assert K[0, 0] == pytest.approx(cam["fx"])
    # the stored depth is the rendered depth to the format's quantum
    from portbench.harness.sequence import render, texture_phases
    _, z = render(torch.as_tensor(poses[:1]), cam, c.traffic["room_size"],
                  texture_phases(c.traffic["texture_seed"]))
    if c.traffic.get("sensor") is None:
        np.testing.assert_allclose(
            seq.read(0, cam["image_height"], cam["image_width"])[1],
            z[0].numpy(), atol=0.51 / cam["png_depth_scale"] + 1e-6)


def test_a_seed_gives_the_same_files(fr1_root, tmp_path):
    c = tiny_cell("fr1.desk", fr1_root)
    c.traffic["frames"] = 3
    a = write_sequence(str(tmp_path / "a"), "tum", c.config["camera"],
                       c.traffic, 9, "cpu", threads=1)
    b = write_sequence(str(tmp_path / "b"), "tum", c.config["camera"],
                       c.traffic, 9, "cpu", threads=1)
    assert a == b
    for r, _, fs in os.walk(tmp_path / "a"):
        for f in fs:
            p = os.path.join(r, f)
            q = p.replace(str(tmp_path / "a"), str(tmp_path / "b"))
            assert open(p, "rb").read() == open(q, "rb").read(), f
