"""Quality metrics: PSNR and ATE (Horn alignment).

The port's own copy of `vtgaussian_slam_tpu/eval/metrics.py` (numpy only):
  - calc_psnr: per-channel MSE over flattened channel rows, 20*log10(1/sqrt)
  - ATE: closed-form Horn alignment (SVD, reflection-corrected) of the two
    trajectories' translations, mean translational error
"""
from __future__ import annotations

import numpy as np


def calc_psnr(img1: np.ndarray, img2: np.ndarray) -> np.ndarray:
    """Per-channel PSNR of (C, H, W) arrays (value range [0, 1])."""
    c = img1.shape[0]
    mse = ((img1 - img2) ** 2).reshape(c, -1).mean(1)
    return 20 * np.log10(1.0 / np.sqrt(mse))


def align_horn(model: np.ndarray, data: np.ndarray):
    """Align trajectory `model` (3, n) onto `data` (3, n); returns
    (rot, trans, per-point translational error)."""
    model_c = model - model.mean(1, keepdims=True)
    data_c = data - data.mean(1, keepdims=True)
    W = model_c @ data_c.T
    U, _, Vh = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vh
    trans = data.mean(1, keepdims=True) - rot @ model.mean(1, keepdims=True)
    err = rot @ model + trans - data
    return rot, trans, np.sqrt((err * err).sum(0))


def evaluate_ate(gt_traj: list, est_traj: list) -> float:
    """Mean translational error between aligned c2w trajectories."""
    gt = np.stack([np.asarray(T)[:3, 3] for T in gt_traj], 1)
    est = np.stack([np.asarray(T)[:3, 3] for T in est_traj], 1)
    _, _, err = align_horn(gt, est)
    return float(err.mean())
