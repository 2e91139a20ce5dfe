"""Host-side image ops: geometric edge mask (numpy Canny + dilate).

The numpy path of `vtgaussian_slam_tpu/ops/image.py`: Canny(50, 200) on
the grayscale image (Sobel gradients, non-maximum suppression, hysteresis)
dilated 3x3 once; the mask gates which high-resolution pixels the
densification stream back-projects. The port does not depend on OpenCV.
"""
from __future__ import annotations

import numpy as np


def geometric_edge_mask(rgb_image: np.ndarray, dilate: bool = True,
                        RGB: bool = True) -> np.ndarray:
    """uint8 edge mask (0/255) of an (H, W, 3) image."""
    return _canny_numpy(np.asarray(rgb_image), RGB=RGB, dilate=dilate)


def _canny_numpy(img: np.ndarray, RGB: bool, dilate: bool,
                 low: float = 50.0, high: float = 200.0) -> np.ndarray:
    """Minimal Canny: Sobel gradients + NMS + double-threshold hysteresis."""
    w = np.array([0.299, 0.587, 0.114]) if RGB else np.array([0.114, 0.587, 0.299])
    gray = (img[..., :3].astype(np.float64) @ w)

    kx = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], float)
    ky = kx.T

    def conv(a, k):
        out = np.zeros_like(a)
        ap = np.pad(a, 1, mode="edge")
        for i in range(3):
            for j in range(3):
                out += k[i, j] * ap[i: i + a.shape[0], j: j + a.shape[1]]
        return out

    gx, gy = conv(gray, kx), conv(gray, ky)
    mag = np.hypot(gx, gy)
    ang = (np.rad2deg(np.arctan2(gy, gx)) + 180.0) % 180.0

    # non-maximum suppression along the gradient direction
    mp = np.pad(mag, 1)
    H, W = mag.shape
    n1 = np.zeros_like(mag)
    n2 = np.zeros_like(mag)
    sel_h = (ang < 22.5) | (ang >= 157.5)
    sel_d1 = (ang >= 22.5) & (ang < 67.5)
    sel_v = (ang >= 67.5) & (ang < 112.5)
    sel_d2 = (ang >= 112.5) & (ang < 157.5)
    pairs = {
        "h": (mp[1: H + 1, 2: W + 2], mp[1: H + 1, 0:W]),
        "d1": (mp[2: H + 2, 2: W + 2], mp[0:H, 0:W]),
        "v": (mp[2: H + 2, 1: W + 1], mp[0:H, 1: W + 1]),
        "d2": (mp[2: H + 2, 0:W], mp[0:H, 2: W + 2]),
    }
    for sel, key in ((sel_h, "h"), (sel_d1, "d1"), (sel_v, "v"), (sel_d2, "d2")):
        a, b = pairs[key]
        n1 = np.where(sel, a, n1)
        n2 = np.where(sel, b, n2)
    nms = np.where((mag >= n1) & (mag >= n2), mag, 0.0)

    strong = nms >= high
    weak = (nms >= low) & ~strong
    # hysteresis: keep weak pixels connected to strong ones (few passes)
    keep = strong.copy()
    for _ in range(8):
        kp = np.pad(keep, 1)
        neigh = np.zeros_like(keep)
        for di in range(3):
            for dj in range(3):
                neigh |= kp[di: di + H, dj: dj + W]
        new = keep | (weak & neigh)
        if np.array_equal(new, keep):
            break
        keep = new
    edges = (keep * 255).astype(np.uint8)
    if dilate:
        ep = np.pad(edges, 1)
        out = np.zeros_like(edges)
        for di in range(3):
            for dj in range(3):
                out = np.maximum(out, ep[di: di + H, dj: dj + W])
        edges = out
    return edges


def resize_mask_nearest(mask: np.ndarray, width: int, height: int) -> np.ndarray:
    """Nearest-neighbour mask resize."""
    ys = (np.arange(height) * mask.shape[0] / height).astype(int)
    xs = (np.arange(width) * mask.shape[1] / width).astype(int)
    return mask[ys][:, xs]
