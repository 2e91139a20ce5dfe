"""Pinhole camera for the rasterizer.

Parity: `vtgaussian_slam_tpu/ops/camera.py`. Gaussians are transformed to
the camera frame before rasterization, so the camera holds only the
intrinsics and the image size.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Camera(NamedTuple):
    height: int
    width: int
    fx: float
    fy: float
    cx: float
    cy: float
    near: float = 0.01
    far: float = 100.0

    @property
    def tanfovx(self) -> float:
        return self.width / (2.0 * self.fx)

    @property
    def tanfovy(self) -> float:
        return self.height / (2.0 * self.fy)

    @property
    def intrinsics(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )


def setup_camera(w: int, h: int, k, w2c=None, near: float = 0.01,
                 far: float = 100.0) -> Camera:
    """Build a Camera from a 3x3 intrinsics matrix (`w2c` is accepted for
    signature compatibility and unused)."""
    k = np.asarray(k)
    return Camera(height=int(h), width=int(w), fx=float(k[0][0]),
                  fy=float(k[1][1]), cx=float(k[0][2]), cy=float(k[1][2]),
                  near=near, far=far)
