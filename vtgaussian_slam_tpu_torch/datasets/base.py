"""Base RGB-D dataset: the gradslam frame contract on numpy arrays.

The port's own copy of `vtgaussian_slam_tpu/datasets/base.py`:

  dataset[idx] -> (color [H,W,3] float32 in 0..255,
                   depth [H,W,1] float32 metres,
                   intrinsics [4,4] float32 (rescaled to the desired size),
                   c2w pose [4,4] float32, relative to frame 0)

Frames stay host numpy (the engine stages them on the device). Decode and
resize go through imageio and cv2 (colour INTER_LINEAR, depth
INTER_NEAREST, depth / png_depth_scale, undistortion of the colour after
the resize with the original-resolution K, poses made relative via
T0^-1 @ Ti). Both are imported when a frame is read, never at import time:
the synthetic path runs without them.
"""
from __future__ import annotations

import numpy as np


def as_intrinsics_matrix(fx, fy, cx, cy) -> np.ndarray:
    K = np.eye(3, dtype=np.float64)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
    return K


def relative_poses_np(poses: np.ndarray) -> np.ndarray:
    """Make c2w poses relative to the first frame: T0^-1 @ Ti."""
    inv0 = np.linalg.inv(poses[0])
    return np.einsum("ij,njk->nik", inv0, poses)


class RGBDDataset:
    """Sequence of RGB-D frames with intrinsics and ground-truth poses."""

    def __init__(
        self,
        config_dict: dict,
        stride: int | None = 1,
        start: int = 0,
        end: int = -1,
        desired_height: int = 480,
        desired_width: int = 640,
        relative_pose: bool = True,
        **kwargs,
    ):
        cp = config_dict["camera_params"]
        self.name = config_dict["dataset_name"]
        self.png_depth_scale = cp["png_depth_scale"]
        self.orig_height = cp["image_height"]
        self.orig_width = cp["image_width"]
        self.fx, self.fy = cp["fx"], cp["fy"]
        self.cx, self.cy = cp["cx"], cp["cy"]
        dist = cp.get("distortion")
        # `distortion: null` in a YAML arrives as None
        self.distortion = np.array(dist) if dist is not None else None
        self.crop_edge = cp.get("crop_edge", None)

        self.desired_height = desired_height
        self.desired_width = desired_width
        self.h_ratio = desired_height / self.orig_height
        self.w_ratio = desired_width / self.orig_width

        if start < 0:
            raise ValueError(f"start must be non-negative, got {start}")
        if not (end == -1 or end > start):
            raise ValueError(f"end ({end}) must be -1 or > start ({start})")

        self.color_paths, self.depth_paths = self.get_filepaths()
        if len(self.color_paths) != len(self.depth_paths):
            raise ValueError("color/depth count mismatch")
        self.num_imgs = len(self.color_paths)
        poses = self.load_poses()  # list of (4,4) numpy c2w

        if end == -1:
            end = self.num_imgs
        stride = stride or 1
        self.color_paths = self.color_paths[start:end:stride]
        self.depth_paths = self.depth_paths[start:end:stride]
        poses = poses[start:end:stride]
        self.num_imgs = len(self.color_paths)

        poses = np.stack(poses).astype(np.float64)
        self.poses = relative_poses_np(poses) if relative_pose else poses

    def __len__(self) -> int:
        return self.num_imgs

    # -- subclass hooks ------------------------------------------------------
    def get_filepaths(self):
        raise NotImplementedError

    def load_poses(self):
        raise NotImplementedError

    def read_color(self, path: str) -> np.ndarray:
        import imageio.v2 as imageio
        return np.asarray(imageio.imread(path), dtype=np.float64)

    def read_depth(self, path: str) -> np.ndarray:
        import imageio.v2 as imageio
        return np.asarray(imageio.imread(path), dtype=np.int64)

    # -- frame assembly ------------------------------------------------------
    def get_cam_K(self) -> np.ndarray:
        return as_intrinsics_matrix(self.fx, self.fy, self.cx, self.cy)

    def scaled_intrinsics(self) -> np.ndarray:
        K = self.get_cam_K().copy()
        K[0] *= self.w_ratio
        K[1] *= self.h_ratio
        out = np.eye(4, dtype=np.float32)
        out[:3, :3] = K
        return out

    def __getitem__(self, index: int):
        try:
            import cv2
        except ImportError as e:
            raise ImportError(
                "opencv-python is required to decode dataset frames") from e
        color = self.read_color(self.color_paths[index])
        color = cv2.resize(
            color, (self.desired_width, self.desired_height),
            interpolation=cv2.INTER_LINEAR,
        )
        if self.distortion is not None:
            # the reference's order: resize first, then undistort with the
            # original-resolution K (colour only, not depth)
            color = cv2.undistort(color, self.get_cam_K(), self.distortion)
        depth = self.read_depth(self.depth_paths[index]).astype(np.float64)
        depth = cv2.resize(
            depth, (self.desired_width, self.desired_height),
            interpolation=cv2.INTER_NEAREST,
        )
        depth = depth[..., None] / self.png_depth_scale
        return (
            color.astype(np.float32),
            depth.astype(np.float32),
            self.scaled_intrinsics(),
            self.poses[index].astype(np.float32),
        )
