"""Per-format RGB-D dataset loaders.

The port's own copy of `vtgaussian_slam_tpu/datasets/loaders.py`, on the
numpy frame contract of `RGBDDataset`. File layouts and pose conventions:

  Replica    - results/frame*.jpg + results/depth*.png, traj.txt of flat
               4x4 c2w rows; ReplicaV2 - imap/00 (train) or imap/01 (test,
               anchored on the first train frame).
  TUM        - rgb.txt/depth.txt/groundtruth.txt with timestamp association
               (max_dt 0.08 s) and 1/32 s frame-rate thinning.
  ScanNet    - color/*.jpg, depth/*.png, pose/*.txt of 4x4 c2w.
  ScanNet++  - dslr/nerfstudio/transforms_undistorted.json, undistorted
               images/depths, train/test split json, OpenGL->GradSLAM axis
               flip P @ c2w @ P^T.
  ICL        - rgb/depth folders + *.gt.sim (3 rows per pose) or
               *.gt.freiburg pose lines.
  Azure      - color/depth folders + an odometry file (.log or 4x4 rows).
  Ai2thor, Record3D, Realsense, NeRFCapture, KITTI - as their docstrings say.
"""
from __future__ import annotations

import glob
import json
import os

import numpy as np

from .base import RGBDDataset

try:
    from natsort import natsorted
except ImportError:  # pragma: no cover
    def natsorted(seq):
        import re

        def key(s):
            return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]
        return sorted(seq, key=key)


def _pose_from_tq(vec: np.ndarray) -> np.ndarray:
    """(tx ty tz qx qy qz qw) -> 4x4 c2w."""
    from scipy.spatial.transform import Rotation

    pose = np.eye(4)
    pose[:3, :3] = Rotation.from_quat(vec[3:7]).as_matrix()
    pose[:3, 3] = vec[:3]
    return pose


class ReplicaDataset(RGBDDataset):
    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        self.pose_path = os.path.join(self.input_folder, "traj.txt")
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        color = natsorted(glob.glob(f"{self.input_folder}/results/frame*.jpg"))
        depth = natsorted(glob.glob(f"{self.input_folder}/results/depth*.png"))
        return color, depth

    def load_poses(self):
        with open(self.pose_path) as f:
            lines = f.readlines()
        return [np.array(list(map(float, lines[i].split()))).reshape(4, 4)
                for i in range(self.num_imgs)]


class ReplicaV2Dataset(ReplicaDataset):
    def __init__(self, config_dict, basedir, sequence,
                 use_train_split: bool = True, **kwargs):
        self.use_train_split = use_train_split
        self.train_input_folder = os.path.join(basedir, sequence, "imap/00")
        split = "imap/00" if use_train_split else "imap/01"
        self.input_folder = os.path.join(basedir, sequence, split)
        self.pose_path = os.path.join(self.input_folder, "traj_w_c.txt")
        self.train_pose_path = os.path.join(self.train_input_folder,
                                            "traj_w_c.txt")
        RGBDDataset.__init__(self, config_dict, **kwargs)

    def get_filepaths(self):
        color = natsorted(glob.glob(f"{self.input_folder}/rgb/rgb_*.png"))
        depth = natsorted(glob.glob(f"{self.input_folder}/depth/depth_*.png"))
        if not self.use_train_split:
            # the reference prepends the FIRST TRAIN frame to the test split
            # (replica.py:108-129) so relative poses anchor on the train
            # world frame the map was built in
            color = [f"{self.train_input_folder}/rgb/rgb_0.png"] + color
            depth = [f"{self.train_input_folder}/depth/depth_0.png"] + depth
        return color, depth

    def load_poses(self):
        poses = []
        if not self.use_train_split:
            with open(self.train_pose_path) as f:
                first = f.readline()
            poses.append(
                np.array(list(map(float, first.split()))).reshape(4, 4))
        with open(self.pose_path) as f:
            lines = f.readlines()
        n = self.num_imgs - len(poses)
        poses += [np.array(list(map(float, lines[i].split()))).reshape(4, 4)
                  for i in range(n)]
        return poses


class TUMDataset(RGBDDataset):
    FRAME_RATE = 32

    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        self._assoc = None
        super().__init__(config_dict, **kwargs)

    def _associate(self):
        if self._assoc is not None:
            return self._assoc
        folder = self.input_folder
        pose_file = os.path.join(folder, "groundtruth.txt")
        if not os.path.isfile(pose_file):
            pose_file = os.path.join(folder, "pose.txt")
        image_data = np.loadtxt(os.path.join(folder, "rgb.txt"), dtype=str)
        depth_data = np.loadtxt(os.path.join(folder, "depth.txt"), dtype=str)
        pose_data = np.loadtxt(pose_file, dtype=str, skiprows=1)
        t_img = image_data[:, 0].astype(np.float64)
        t_dep = depth_data[:, 0].astype(np.float64)
        t_pos = pose_data[:, 0].astype(np.float64)

        # nearest-timestamp association within max_dt = 0.08 s
        assoc = []
        for i, t in enumerate(t_img):
            j = int(np.argmin(np.abs(t_dep - t)))
            k = int(np.argmin(np.abs(t_pos - t)))
            if abs(t_dep[j] - t) < 0.08 and abs(t_pos[k] - t) < 0.08:
                assoc.append((i, j, k))

        # thin to at most FRAME_RATE fps
        keep = [0]
        for n in range(1, len(assoc)):
            if t_img[assoc[n][0]] - t_img[assoc[keep[-1]][0]] > 1.0 / self.FRAME_RATE:
                keep.append(n)

        self._assoc = (
            [os.path.join(folder, image_data[assoc[n][0], 1]) for n in keep],
            [os.path.join(folder, depth_data[assoc[n][1], 1]) for n in keep],
            [pose_data[assoc[n][2], 1:8].astype(np.float64) for n in keep],
        )
        return self._assoc

    def get_filepaths(self):
        color, depth, _ = self._associate()
        return color, depth

    def load_poses(self):
        _, _, vecs = self._associate()
        return [_pose_from_tq(v) for v in vecs]


class ScannetDataset(RGBDDataset):
    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        color = natsorted(glob.glob(f"{self.input_folder}/color/*.jpg"))
        depth = natsorted(glob.glob(f"{self.input_folder}/depth/*.png"))
        return color, depth

    def load_poses(self):
        files = natsorted(glob.glob(f"{self.input_folder}/pose/*.txt"))
        return [np.loadtxt(f) for f in files]


# OpenGL -> GradSLAM camera axis flip used by ScanNet++ NeRFStudio poses
_P_FLIP = np.diag([1.0, -1.0, -1.0, 1.0])


class ScannetPPDataset(RGBDDataset):
    def __init__(self, basedir, sequence, ignore_bad: bool = False,
                 use_train_split: bool = True, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        self.ignore_bad = ignore_bad
        self.use_train_split = use_train_split

        split = json.load(
            open(f"{self.input_folder}/dslr/train_test_lists.json"))
        self.image_names = split["train" if use_train_split else "test"]
        self.train_image_names = split["train"]

        meta = json.load(open(
            f"{self.input_folder}/dslr/nerfstudio/transforms_undistorted.json"))
        self.cams_metadata = meta
        self.frames_meta = meta["frames" if use_train_split else "test_frames"]
        self.train_frames_meta = meta["frames"]
        self._by_name = {fr["file_path"]: fr for fr in self.frames_meta}
        self._train_by_name = {fr["file_path"]: fr for fr in self.train_frames_meta}

        config_dict = {
            "dataset_name": "scannetpp",
            "camera_params": {
                "png_depth_scale": 1000.0,  # depth stored in millimeters
                "image_height": meta["h"],
                "image_width": meta["w"],
                "fx": meta["fl_x"],
                "fy": meta["fl_y"],
                "cx": meta["cx"],
                "cy": meta["cy"],
            },
        }
        super().__init__(config_dict, **kwargs)

    def _paths_and_poses(self):
        base = f"{self.input_folder}/dslr"
        names = list(self.image_names)
        metas = self._by_name
        entries = []
        if not self.use_train_split:
            # prepend the first train frame so relative poses anchor on it
            first = self.train_image_names[0]
            entries.append((first, self._train_by_name[first]))
        for name in names:
            fr = metas[name]
            if self.ignore_bad and fr.get("is_bad", False):
                continue
            entries.append((name, fr))
        colors, depths, poses = [], [], []
        for name, fr in entries:
            colors.append(f"{base}/undistorted_images/{name}")
            depths.append(
                f"{base}/undistorted_depths/{name.replace('.JPG', '.png')}")
            c2w = np.array(fr["transform_matrix"], dtype=np.float64)
            poses.append(_P_FLIP @ c2w @ _P_FLIP.T)
        return colors, depths, poses

    def get_filepaths(self):
        colors, depths, poses = self._paths_and_poses()
        self._poses_cache = poses
        return colors, depths

    def load_poses(self):
        return self._poses_cache


class ICLDataset(RGBDDataset):
    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        color = natsorted(glob.glob(f"{self.input_folder}/rgb/*.png"))
        depth = natsorted(glob.glob(f"{self.input_folder}/depth/*.png"))
        return color, depth

    def load_poses(self):
        # the reference parses *.gt.sim — 3 rows of 4 floats per pose
        # (icl.py:31-35, 60-84); *.gt.freiburg (tx ty tz qx qy qz qw) is
        # kept as a fallback for sequences prepared without the .sim file
        sim = glob.glob(f"{self.input_folder}/*.gt.sim")
        if sim:
            rows = [list(map(float, ln.split()))
                    for ln in open(sim[0]) if ln.strip()]
            arr = np.asarray(rows, np.float64)
            poses = []
            for i in range(0, arr.shape[0], 3):
                p = np.eye(4)
                p[:3, :4] = arr[i:i + 3]
                poses.append(p)
            return poses
        gt = glob.glob(f"{self.input_folder}/*.gt.freiburg")
        if not gt:
            raise FileNotFoundError(
                f"no *.gt.sim or *.gt.freiburg pose file in "
                f"{self.input_folder}")
        lines = np.loadtxt(gt[0], dtype=np.float64)
        return [_pose_from_tq(l[1:8]) for l in lines]


class AzureKinectDataset(RGBDDataset):
    def __init__(self, config_dict, basedir, sequence, odomfile=None,
                 **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        # reference semantics (azure.py:59-104): pose file comes from the
        # `odomfile` kwarg; no file -> identity poses with a warning
        self.pose_path = (os.path.join(self.input_folder, odomfile)
                          if odomfile else None)
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        color = natsorted(glob.glob(f"{self.input_folder}/color/*.jpg"))
        depth = natsorted(glob.glob(f"{self.input_folder}/depth/*.png"))
        return color, depth

    def load_poses(self):
        if self.pose_path is None:
            fallback = os.path.join(self.input_folder, "poses_global_dvo.txt")
            if os.path.isfile(fallback):
                self.pose_path = fallback
            else:
                print("WARNING: Dataset does not contain poses. "
                      "Returning identity transform.")
                return [np.eye(4) for _ in range(self.num_imgs)]
        if self.pose_path.endswith(".log"):
            # .log: 5 lines per frame — metadata then 4 matrix rows
            lines = [ln for ln in open(self.pose_path)]
            if len(lines) % 5 != 0:
                raise ValueError("Incorrect .log odom file: line count must "
                                 "be a multiple of 5")
            return [np.array([list(map(float, lines[5 * i + r].split()))
                              for r in range(1, 5)]).reshape(4, 4)
                    for i in range(len(lines) // 5)]
        rows = [list(map(float, ln.split()))
                for ln in open(self.pose_path) if ln.split()]
        return [np.asarray(r, np.float64).reshape(4, 4) for r in rows]


class Ai2thorDataset(RGBDDataset):
    """color/*.png + depth/*.png + pose/*.txt (ai2thor.py)."""

    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        color = natsorted(glob.glob(f"{self.input_folder}/color/*.png"))
        depth = natsorted(glob.glob(f"{self.input_folder}/depth/*.png"))
        return color, depth

    def load_poses(self):
        files = natsorted(glob.glob(f"{self.input_folder}/pose/*.txt"))
        return [np.loadtxt(f) for f in files]


class Record3DDataset(RGBDDataset):
    """rgb/*.png + depth/*.png + poses/*.npy with OpenGL flip (record3d.py)."""

    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        self.pose_path = os.path.join(self.input_folder, "poses")
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        color = natsorted(glob.glob(f"{self.input_folder}/rgb/*.png"))
        depth = natsorted(glob.glob(f"{self.input_folder}/depth/*.png"))
        return color, depth

    def load_poses(self):
        files = natsorted(glob.glob(os.path.join(self.pose_path, "*.npy")))
        return [_P_FLIP @ np.load(f) @ _P_FLIP.T for f in files]


class RealsenseDataset(Record3DDataset):
    """rgb/*.jpg + depth/*.png + poses/*.npy with OpenGL flip (realsense.py)."""

    def get_filepaths(self):
        color = natsorted(glob.glob(f"{self.input_folder}/rgb/*.jpg"))
        depth = natsorted(glob.glob(f"{self.input_folder}/depth/*.png"))
        return color, depth


class NeRFCaptureDataset(RGBDDataset):
    """transforms.json (NeRFStudio) with rgb/depth paths + OpenGL flip
    (nerfcapture.py)."""

    def __init__(self, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        meta = json.load(open(f"{self.input_folder}/transforms.json"))
        self.cams_metadata = meta
        self.frames_meta = meta["frames"]
        self._by_name = {fr["file_path"]: fr for fr in self.frames_meta}
        self.image_names = [fr["file_path"] for fr in self.frames_meta]
        config_dict = {
            "dataset_name": "nerfcapture",
            "camera_params": {
                "png_depth_scale": 6553.5,
                "image_height": meta["h"],
                "image_width": meta["w"],
                "fx": meta["fl_x"],
                "fy": meta["fl_y"],
                "cx": meta["cx"],
                "cy": meta["cy"],
            },
        }
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        colors, depths, poses = [], [], []
        for name in self.image_names:
            fr = self._by_name[name]
            colors.append(f"{self.input_folder}/{name}")
            depths.append(f"{self.input_folder}/{name.replace('rgb', 'depth')}")
            c2w = np.array(fr["transform_matrix"], dtype=np.float64)
            poses.append(_P_FLIP @ c2w @ _P_FLIP.T)
        self._poses_cache = poses
        return colors, depths

    def load_poses(self):
        return self._poses_cache


class KittiDataset(RGBDDataset):
    """KITTI odometry-style layout (image_2/*.png + proj depth). Present for
    loader-family completeness; like the reference (kitti.py exists but has
    no `get_dataset` branch), it is not wired into the factory by default."""

    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        color = natsorted(glob.glob(f"{self.input_folder}/rgb/*.png"))
        depth = natsorted(glob.glob(f"{self.input_folder}/depth/*.png"))
        return color, depth

    def load_poses(self):
        pose_file = os.path.join(self.input_folder, "poses.txt")
        rows = np.loadtxt(pose_file).reshape(-1, 3, 4)
        return [np.vstack([r, [0, 0, 0, 1]]) for r in rows]
