"""Dataset frame contract helpers (numpy).

Frames are `(color [H,W,3] f32 0..255, depth [H,W,1] f32 metres,
intrinsics [4,4] f32, c2w pose [4,4] f32 relative to frame 0)`, as in
`vtgaussian_slam_tpu/datasets/base.py`. The real-data loaders arrive in a
later slice.
"""
from __future__ import annotations

import numpy as np


def relative_poses_np(poses: np.ndarray) -> np.ndarray:
    """Make c2w poses relative to the first frame: T0^-1 @ Ti."""
    inv0 = np.linalg.inv(poses[0])
    return np.einsum("ij,njk->nik", inv0, poses)
