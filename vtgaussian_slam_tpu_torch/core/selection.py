"""Keyframe / base-frame overlap selection.

Parity: `vtgaussian_slam_tpu/core/selection.py`. `overlap_percents` scores
every candidate keyframe at once: back-project the current depth (sampled
pixels, or all of them), reproject into each candidate camera and count the
points inside its image (edge margin, z > 0) and, in vis mode, consistent
with the candidate's depth within `kf_depth_thresh`. The list logic on top
(sorting, threshold decay, the earliest-chain walk) is host Python over
scalars, copied from the JAX package.

The sampled mode draws its pixels by rank into the prefix sum of valid
depth; the ranks come from a `torch.Generator`, or tests inject the JAX
engine's ranks (`jax.random` and torch generators give different streams).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import geometry as geo


@torch.no_grad()
def overlap_percents(gt_depth: torch.Tensor, w2c: torch.Tensor,
                     intrinsics: torch.Tensor, kf_w2cs: torch.Tensor,
                     kf_depths: torch.Tensor, ranks: torch.Tensor | None = None,
                     pixels: int = 1600, edge: int = 20, use_vis: bool = False,
                     kf_depth_thresh: float = 0.01, depth_stride: int = 1,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """(B,) percent of the current frame's sampled valid pixels inside each
    of the B candidates (kf_w2cs (B, 4, 4); kf_depths (B, H/s, W/s), the
    candidate depths subsampled by `depth_stride`, read in vis mode).
    `pixels` > 0 samples that many valid pixels by `ranks` (pixels,) into
    the valid prefix sum, or, without `ranks`, by uniform draws of the
    host `generator` scaled on the device by the valid count (no host
    read); 0 scores every valid pixel."""
    H, W = gt_depth.shape
    dev = gt_depth.device
    valid = gt_depth.reshape(-1) > 0
    if pixels > 0:
        n_valid = valid.sum()
        if ranks is None:
            u = torch.rand(pixels, generator=generator).to(dev)
            n1 = torch.clamp(n_valid, min=1)
            ranks = torch.minimum((u * n1).long(), n1 - 1)
        cum = torch.cumsum(valid.to(torch.int32), 0) - 1
        ranks = torch.as_tensor(np.array(ranks) if isinstance(ranks, np.ndarray)
                                else ranks, device=dev).to(torch.int32)
        idx = torch.searchsorted(cum, ranks, side="left")
        idx = torch.clamp(idx, max=H * W - 1)
        # a frame with no valid depth scores 0 everywhere
        pmask = (n_valid > 0).expand(pixels)
    else:
        idx = torch.arange(H * W, device=dev)
        pmask = valid
    rows = torch.div(idx, W, rounding_mode="floor")
    cols = idx % W
    pts = geo.backproject_at(gt_depth, intrinsics, rows, cols,
                             c2w=geo.invert_se3(w2c))
    denom = torch.clamp(pmask.sum(), min=1)
    out = []
    for b in range(kf_w2cs.shape[0]):
        uv, z = geo.project_points(geo.transform_points(kf_w2cs[b], pts),
                                   intrinsics)
        m = ((uv[:, 0] < W - edge) & (uv[:, 0] > edge)
             & (uv[:, 1] < H - edge) & (uv[:, 1] > edge) & (z > 0) & pmask)
        if use_vis:
            # stored pixel (i, j) holds the full-res sample at (i s, j s)
            d = geo.bilinear_sample(kf_depths[b], uv / depth_stride)
            m = m & ((d - z).abs() < kf_depth_thresh * torch.minimum(d, z))
        out.append(m.sum() / denom)
    return torch.stack(out)


def select_topk_overlap(percents: np.ndarray, k: int) -> list[int]:
    """Ids by percent, descending (stable), keeping > 0; the first k."""
    order = sorted(range(len(percents)), key=lambda i: -float(percents[i]))
    return [i for i in order if percents[i] > 0.0][:k]


def select_visbased(percents: np.ndarray, k: int, earliest_thres: float = 0.5):
    """(top-k ids, earliest id above the threshold)."""
    order = sorted(range(len(percents)), key=lambda i: -float(percents[i]))
    selected = [i for i in order if percents[i] > 0.0][:k]
    above = [i for i in order if percents[i] > earliest_thres]
    earliest = [above[-1]] if above else list(selected)
    return selected, earliest


def select_earliest_topk_base(percents: np.ndarray, config: dict,
                              earliest_thres: float, lower_percent: float,
                              topk_base: int | None) -> list[int]:
    """Dynamic-threshold earliest base-section selection: decay the overlap
    threshold by `lower_percent` until >= 3 distinct base sections qualify
    (or the pool is small, or the threshold falls below 0.01), then return
    the earliest `topk_base` section ids."""
    n = len(percents)
    num_overlap_in_base = int(config["baseframe_every"] / config["overlap_every"])
    entries = sorted(range(n), key=lambda i: -float(percents[i]))
    thres = earliest_thres
    it = 0
    while True:
        if it > 0:
            thres = lower_percent * thres
        filtered = [i for i in entries if percents[i] > thres]
        quantized = sorted({i // num_overlap_in_base for i in filtered})
        it += 1
        if (len(quantized) >= 3
                or (n <= 3 * num_overlap_in_base and len(quantized) > 0)
                or thres < 0.01):
            break
    if not filtered:
        filtered = [n - 1]      # fall back to the latest keyframe
    filtered = sorted(filtered)
    quantized = sorted({i // num_overlap_in_base for i in filtered})
    if topk_base is None:
        return sorted({filtered[0] // num_overlap_in_base})
    return quantized[: min(topk_base, len(quantized))]


def find_earliest_keyframe(corr_list: list, score_one, baseframe_every: int,
                           threshold: float) -> int:
    """Walk the tracking correspondence chain ([keyframe id, latest id,
    current id] entries) back while the current frame's overlap with the
    entry's base frame, `score_one(base index)`, stays above `threshold`."""
    rev = corr_list[::-1]
    current = rev[0][0]
    earliest = current
    while current >= 0:
        current = next((i for i, _, x in rev if x == current), -100)
        if current >= 0:
            if score_one(int(current / baseframe_every)) > threshold:
                earliest = current
            else:
                break
    return earliest
