"""Sequence evaluation: render each frame from its section, score it.

Parity: `vtgaussian_slam_tpu/eval/evaluate.py` (`eval_sequence`, the
reference's `eval`). Per `eval_every` frame: pick the frame's section,
render RGB and depth / silhouette at the estimated pose (`render_slam`,
whose blend is K4 on the card), and score the valid-depth-masked PSNR,
MS-SSIM, LPIPS (optional, see lpips.py), depth L1 and the reference's
"depth RMSE"; then the Horn-aligned ATE of the whole trajectory, the five
metric .txt files, an optional metrics plot and the rendered-frame PNGs.

`frame_metrics` scores one rendered frame; the engine's per-frame print
(`VTGaussianSLAM.evaluate_frame`) and `eval_sequence` share it. Images and
depths are scored in numpy on the host as the JAX package scores them;
MS-SSIM and LPIPS run on the eval device. Mesh evaluation (`eval_recon`)
is not ported yet.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core.config import auto_pair_budget
from ..core.losses import render_slam
from ..models import gaussians as G
from ..ops import geometry as geo
from ..ops.camera import setup_camera
from ..ops.ssim import ms_ssim
from ..utils.common import resolve_device
from .metrics import calc_psnr, evaluate_ate


def eval_pair_budget(n: int, height: int, width: int,
                     tpu_cfg: dict | None = None) -> dict:
    """Generous rasterizer kwargs for rendering a map of `n` Gaussians.

    A map trained at pair budget B composites up to B splats deep per tile;
    rendering it with a smaller budget truncates trained tails and
    under-reports quality. Where the training budget is unknown (eval_mode,
    the engine's per-frame print), budget the full average per-tile pair
    count, memory-capped."""
    tpu_cfg = tpu_cfg or {}
    span = tpu_cfg.get("span_cap", 3)
    base = max(tpu_cfg.get("max_pairs_per_tile", 512), 512)
    tiles = (-(-width // 16)) * (-(-height // 16))
    mpt = auto_pair_budget(n, tiles, span, base, hard_cap=16384)
    # eval is offline: spend the full average density, not 1/12 of it
    cap = max(base, min(16384, (1 << 23) // max(tiles, 1)))
    need = n * span * span // max(tiles, 1)
    while mpt < need and mpt * 2 <= cap:
        mpt *= 2
    return {"max_pairs_per_tile": mpt, "span_cap": span,
            "chunk": tpu_cfg.get("blend_chunk", 128)}


def eval_backend_kwargs(params_ls: list[dict], height: int, width: int,
                        tpu_cfg: dict | None = None) -> dict:
    """`eval_pair_budget` for the largest section of a saved params_ls."""
    n = max((int(np.asarray(p["means3D"]).shape[0]) for p in params_ls),
            default=0)
    return eval_pair_budget(n, height, width, tpu_cfg)


def _load_sections_and_renderer(params_ls: list[dict],
                                backend_kwargs: dict | None, device="cuda"):
    """Sections and the trajectory from saved params (the trajectory of the
    LAST section, as the reference reads it), and a no-grad renderer."""
    sections, traj = [], None
    for p in params_ls:
        sec, tr = G.section_from_numpy_params(p, device=device)
        sections.append(sec)
        traj = tr
    bk = dict(backend_kwargs or {"max_pairs_per_tile": 512})

    @torch.no_grad()
    def render_fn(prm, act, q, t, cam):
        return render_slam(prm, act, q, t, cam, bk)
    return sections, traj, render_fn


def frame_metrics(r, color, depth, sil_thres: float = 0.5,
                  presence_masked: bool = False, lpips_fn=None,
                  with_ssim: bool = True) -> dict:
    """Scores of one render `r` (a RenderResult) against the dataset's
    frame (color (H, W, 3) in 0..255, depth (H, W, 1) metres): PSNR and
    MS-SSIM over valid-depth pixels, LPIPS of the clipped images when
    `lpips_fn` is given, depth L1 and the reference's "depth RMSE";
    `presence_masked` also masks by the silhouette (a map that never
    trains or grows). Also returns the host arrays for the frame dumps."""
    gt_im = np.transpose(color, (2, 0, 1)) / 255.0
    gt_depth = np.transpose(depth, (2, 0, 1))
    valid = gt_depth > 0
    im = r.im.cpu().numpy()
    depth_r = r.depth.cpu().numpy()
    rastered_depth = depth_r * valid
    if presence_masked:
        presence = r.silhouette.cpu().numpy() > sil_thres
        w_im = im * presence * valid
        w_gt = gt_im * presence * valid
    else:
        w_im = im * valid
        w_gt = gt_im * valid
    out = {"psnr": float(calc_psnr(w_im, w_gt).mean()), "im": im,
           "depth": depth_r, "gt_im": gt_im, "gt_depth": gt_depth}
    dev = r.im.device
    if with_ssim:
        out["ssim"] = float(ms_ssim(
            torch.as_tensor(w_im, dtype=torch.float32, device=dev),
            torch.as_tensor(w_gt, dtype=torch.float32, device=dev)))
    if lpips_fn is not None:
        out["lpips"] = float(lpips_fn(np.clip(w_im, 0, 1),
                                      np.clip(w_gt, 0, 1)))
    diff = rastered_depth - gt_depth
    if presence_masked:
        diff = diff * presence
    vsum = max(valid.sum(), 1)
    # the reference computes "Depth RMSE" as sqrt(diff ** 2) ELEMENTWISE,
    # then the mean: its RMSE column equals its L1 column. Kept, so the
    # numbers stay comparable with the reference's.
    out["rmse"] = float((np.sqrt(diff ** 2) * valid).sum() / vsum)
    out["l1"] = float((np.abs(diff) * valid).sum() / vsum)
    return out


def eval_sequence(
    dataset,
    params_ls: list[dict],
    num_frames: int,
    eval_dir: str,
    sil_thres: float = 0.5,
    mapping_iters: int = 1,
    add_new_gaussians: bool = True,
    eval_every: int = 1,
    baseframe_every: int = 40,
    save_frames: bool = False,
    lpips_fn=None,
    backend_kwargs: dict | None = None,
    device="cuda",
) -> dict:
    device = resolve_device(device)
    os.makedirs(eval_dir, exist_ok=True)
    lists = {k: [] for k in ("psnr", "rmse", "l1", "ssim", "lpips")}

    sections, traj, render_fn = _load_sections_and_renderer(
        params_ls, backend_kwargs, device)

    # the saved trajectory covers only the frames the map was trained on
    T = traj.quats.shape[0]
    if num_frames > T:
        print(f"WARNING: dataset has {num_frames} frames but the saved "
              f"trajectory covers {T}; evaluating the covered prefix")
        num_frames = T

    gt_w2c_list = []
    first_frame_w2c = None
    cam = None
    if save_frames:
        _cv2()      # before any render: a missing OpenCV fails here
        for sub in ("rendered_rgb", "rendered_depth", "rgb", "depth"):
            os.makedirs(os.path.join(eval_dir, sub), exist_ok=True)
    masked = mapping_iters == 0 and not add_new_gaussians

    for t in range(num_frames):
        skipped = t != 0 and t % eval_every != 0
        if skipped and hasattr(dataset, "poses"):
            # the ATE needs only the pose: skip the decode and resize of
            # frames that eval_every passes over
            pose = dataset.poses[t]
            gt_w2c_list.append(np.linalg.inv(np.asarray(pose, np.float64)))
            continue
        color, depth, intrinsics, pose = dataset[t]
        gt_w2c = np.linalg.inv(np.asarray(pose, np.float64))
        gt_w2c_list.append(gt_w2c)
        if t == 0:
            first_frame_w2c = gt_w2c
            K = np.asarray(intrinsics)[:3, :3]
            cam = setup_camera(color.shape[1], color.shape[0], K)
        if skipped:
            continue

        sec = sections[min(t // baseframe_every, len(sections) - 1)]
        r = render_fn(sec.params, sec.active_mask(), traj.quats[t],
                      traj.trans[t], cam)
        m = frame_metrics(r, color, depth, sil_thres, masked, lpips_fn)
        for k in lists:
            if k in m:
                lists[k].append(m[k])
        if save_frames:
            _save_frame_pngs(eval_dir, t, m["im"], m["depth"], m["gt_im"],
                             m["gt_depth"])

    # trajectory metric
    try:
        est, gts = [first_frame_w2c], [gt_w2c_list[0]]
        for idx in range(1, min(T, len(gt_w2c_list))):
            g = gt_w2c_list[idx]
            if np.isnan(g).any() or np.isinf(g).any():
                continue
            w2c = geo.pose_to_w2c(geo.normalize(traj.quats[idx]),
                                  traj.trans[idx]).cpu().numpy()
            est.append(w2c)
            gts.append(g)
        ate_rmse = evaluate_ate([np.linalg.inv(x) for x in gts],
                                [np.linalg.inv(np.asarray(x, np.float64))
                                 for x in est])
    except (ValueError, TypeError, IndexError, np.linalg.LinAlgError):
        ate_rmse = 100.0
        print("Failed to evaluate trajectory with alignment.")

    mean = lambda xs: float(np.mean(xs)) if xs else float("nan")
    results = {
        "psnr": mean(lists["psnr"]), "depth_rmse": mean(lists["rmse"]),
        "depth_l1": mean(lists["l1"]), "ms_ssim": mean(lists["ssim"]),
        "lpips": mean(lists["lpips"]), "ate_rmse": ate_rmse,
    }
    for name, arr in lists.items():
        np.savetxt(os.path.join(eval_dir, f"{name}.txt"), np.array(arr))
    _plot_metrics(eval_dir, lists["psnr"], lists["l1"], results["psnr"],
                  results["depth_l1"], ate_rmse)
    print(f"Average PSNR: {results['psnr']:.2f}")
    print(f"Average Depth RMSE: {results['depth_rmse'] * 100:.2f} cm")
    print(f"Average Depth L1: {results['depth_l1'] * 100:.2f} cm")
    print(f"Average MS-SSIM: {results['ms_ssim']:.3f}")
    print(f"Final Average ATE RMSE: {ate_rmse * 100:.2f} cm")
    return results


def _plot_metrics(eval_dir, psnr_list, l1_list, avg_psnr, avg_l1, ate_rmse):
    """PSNR / depth L1 line plots -> metrics.png; skipped without
    matplotlib."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, axs = plt.subplots(1, 2, figsize=(12, 4))
    axs[0].plot(np.arange(len(psnr_list)), psnr_list)
    axs[0].set_title("RGB PSNR")
    axs[0].set_xlabel("Time Step")
    axs[0].set_ylabel("PSNR")
    axs[1].plot(np.arange(len(l1_list)), np.array(l1_list) * 100)
    axs[1].set_title("Depth L1")
    axs[1].set_xlabel("Time Step")
    axs[1].set_ylabel("L1 (cm)")
    fig.suptitle(
        f"Average PSNR: {avg_psnr:.2f}, Average Depth L1: "
        f"{avg_l1 * 100:.2f} cm, ATE RMSE: {ate_rmse * 100:.2f} cm",
        y=1.05, fontsize=16)
    plt.savefig(os.path.join(eval_dir, "metrics.png"), bbox_inches="tight")
    plt.close()


def _cv2():
    """OpenCV, which writes the frame PNGs as the JAX package writes them."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "eval_sequence(save_frames=True) writes the frame PNGs through "
            "OpenCV (cv2), which does not import here; install it or pass "
            "save_frames=False") from e
    return cv2


def _save_frame_pngs(eval_dir, t, im, depth, gt_im, gt_depth):
    """The rendered and ground-truth RGB and JET-coloured depth (0-6 m) of
    frame t."""
    cv2 = _cv2()
    vmin, vmax = 0, 6

    def depth_png(d):
        norm = np.clip((d[0] - vmin) / (vmax - vmin), 0, 1)
        return cv2.applyColorMap((norm * 255).astype(np.uint8),
                                 cv2.COLORMAP_JET)

    def rgb_png(x):
        arr = np.clip(np.transpose(x, (1, 2, 0)), 0, 1) * 255
        return cv2.cvtColor(arr.astype(np.uint8), cv2.COLOR_RGB2BGR)

    cv2.imwrite(os.path.join(eval_dir, "rendered_rgb", f"gs_{t:04d}.png"),
                rgb_png(im))
    cv2.imwrite(os.path.join(eval_dir, "rendered_depth", f"gs_{t:04d}.png"),
                depth_png(depth))
    cv2.imwrite(os.path.join(eval_dir, "rgb", f"gt_{t:04d}.png"),
                rgb_png(gt_im))
    cv2.imwrite(os.path.join(eval_dir, "depth", f"gt_{t:04d}.png"),
                depth_png(gt_depth))
