"""The online SLAM engine for the frames of the first section.

Parity: `vtgaussian_slam_tpu/core/pipeline.py` (`VTGaussianSLAM`), the
subset that runs frames 0 .. baseframe_every-1: frame 0 seeds the section
from the back-projected frame plus the Canny-masked densification stream
and maps it; every later frame tracks (constant-velocity init), densifies
on a fresh render (K4) and maps. Tracking and mapping each take one of two
routes, chosen as the JAX engine chooses them:

  - tracking: the frozen-binning cache (K1 + K2) for isotropic configs
    with `tpu.track_cache` on (the default); otherwise the generic route,
    which renders from scratch every iteration (K4, backward K5);
  - mapping: the per-keyframe frozen binnings (K1 + K3) for isotropic
    configs whose means3D / unnorm_rotations mapping lrs are zero, with
    `tpu.map_binned` on (its default is on for CUDA and off for the CPU,
    as the JAX default follows the backend); otherwise the generic route.

As in the JAX engine, `gaussian_distribution="anisotropic"` changes the
route but not the Gaussians: sections are seeded with (N, 1) log-scales
either way. Everything that needs a second section (boundary selection,
point-to-plane tracking, section spawning, the frozen-section global
term, paging) arrives in a later slice, and `process_frame` refuses those
frames. The pair budget follows the JAX engine's open-loop
`auto_pair_budget` (boost 1); the measured-harm probe that closes the loop
is not ported yet.

The engine runs on CUDA unless the caller passes device="cpu".
"""
from __future__ import annotations

import os
import time
from typing import Callable

import numpy as np
import torch

from ..datasets import get_dataset
from ..eval.metrics import calc_psnr, evaluate_ate
from ..models import gaussians as G
from ..ops import geometry as geo
from ..ops.camera import setup_camera
from ..ops.image import geometric_edge_mask, resize_mask_nearest
from ..utils.common import resolve_device
from .config import prepare_config, separate_densification_res
from .densify import (densify_from_pixels, densify_nonpresence,
                      first_frame_pointcloud)
from .losses import Frame, LossConfig, render_slam
from .map_cache import MapCacheStore
from .mapping import KeyframeBuffer, MappingConfig, map_frame, map_frame_binned
from .track_cache import build_track_cache
from .tracking import (TrackingConfig, init_track_state, track_frame,
                       track_frame_cached)

BOUNDARY_MSG = "section boundaries arrive in a later port slice"


def auto_pair_budget(n_active: int, n_tiles: int, span_cap: int, base: int,
                     tile_cap_entries: int = 1 << 23, hard_cap: int = 8192,
                     boost: int = 1) -> int:
    """Power-of-two `max_pairs_per_tile` for the current section density:
    about 1/12 of the average per-tile pair count (1/4 on images of fewer
    than 64 tiles), doubled up from `base`, capped so the record buffers
    stay bounded."""
    divisor = 12 if n_tiles >= 64 else 4
    need = boost * (n_active * span_cap * span_cap) // (
        divisor * max(n_tiles, 1))
    cap = max(base, min(hard_cap, tile_cap_entries // max(n_tiles, 1)))
    mpt = base
    while mpt < need and mpt * 2 <= cap:
        mpt *= 2
    return mpt


def eval_backend_kwargs(n: int, height: int, width: int, tpu_cfg: dict) -> dict:
    """Rasterizer kwargs for evaluation renders: the full average per-tile
    pair count, memory-capped (eval/evaluate.py of the JAX package)."""
    span = tpu_cfg.get("span_cap", 3)
    base = max(tpu_cfg.get("max_pairs_per_tile", 512), 512)
    tiles = (-(-width // 16)) * (-(-height // 16))
    mpt = auto_pair_budget(n, tiles, span, base, hard_cap=16384)
    cap = max(base, min(16384, (1 << 23) // max(tiles, 1)))
    need = n * span * span // max(tiles, 1)
    while mpt < need and mpt * 2 <= cap:
        mpt *= 2
    return {"max_pairs_per_tile": mpt, "span_cap": span,
            "chunk": tpu_cfg.get("blend_chunk", 128)}


def build_dataset(config: dict, densify_res: bool = False):
    config = prepare_config(config)
    data_cfg = config["data"]
    if "gradslam_data_cfg" in data_cfg:
        raise NotImplementedError(
            "real-data loaders arrive in a later port slice; configs with "
            "data.dataset_name='synthetic' run now")
    gradslam_cfg = {"dataset_name": data_cfg["dataset_name"]}
    if "synthetic" in data_cfg:
        gradslam_cfg["synthetic"] = data_cfg["synthetic"]
    hw_key = "densification_image" if densify_res else "desired_image"
    return get_dataset(
        config_dict=gradslam_cfg, basedir=data_cfg.get("basedir", ""),
        sequence=os.path.basename(str(data_cfg.get("sequence", ""))),
        start=data_cfg.get("start", 0), end=data_cfg.get("end", -1),
        stride=data_cfg.get("stride", 1),
        desired_height=data_cfg[f"{hw_key}_height"],
        desired_width=data_cfg[f"{hw_key}_width"], relative_pose=True)


class VTGaussianSLAM:
    """map_draws(t, num_iters, count) -> keyframe indices (cache slots on
    the binned route), when given, replaces the mapping generator's draws
    (tests inject the JAX engine's draws through it)."""

    def __init__(self, config: dict, device="cuda",
                 map_draws: Callable[[int, int, int], list] | None = None):
        self.device = resolve_device(device)
        self.config = prepare_config(config)
        cfg = self.config
        data_cfg = cfg["data"]
        mplrs = cfg["mapping"]["lrs"]
        pose_lr = max(float(mplrs.get("cam_unnorm_rots", 0.0)),
                      float(mplrs.get("cam_trans", 0.0)))
        if pose_lr > 1e-5:
            raise NotImplementedError(
                f"mapping pose lrs up to {pose_lr:g}: the engine holds "
                "keyframe poses fixed during mapping")
        tpu = cfg["tpu"]
        isotropic = cfg["gaussian_distribution"] == "isotropic"
        self.track_cached = isotropic and tpu.get("track_cache", True)
        self.map_binned = (
            isotropic and float(mplrs.get("means3D", 0.0)) == 0.0
            and float(mplrs.get("unnorm_rotations", 0.0)) == 0.0
            and tpu.get("map_binned", self.device.type != "cpu"))
        if float(tpu.get("two_class_frac", 0.0)) > 0.0:
            raise NotImplementedError("two-class binning: later slice")
        if cfg["tracking"].get("multiavg", False):
            raise NotImplementedError("multiavg pose propagation")

        self.dataset_name = data_cfg.get("dataset_name", "")
        if self.dataset_name == "synthetic" and cfg.get("selection_style"):
            self.dataset_name = cfg["selection_style"]
        if self.dataset_name == "scannetpp":
            raise NotImplementedError("ScanNet++ odometry: later slice")

        self.dataset = build_dataset(cfg)
        self.sep_densify = separate_densification_res(cfg)
        self.densify_dataset = (build_dataset(cfg, densify_res=True)
                                if self.sep_densify else None)
        self.num_frames = data_cfg.get("num_frames", -1)
        if self.num_frames == -1:
            self.num_frames = len(self.dataset)
        self.bfe = cfg["baseframe_every"]
        self.quantum = tpu["capacity_quantum"]
        self.backend_kwargs = {
            "span_cap": tpu["span_cap"],
            "max_pairs_per_tile": tpu["max_pairs_per_tile"],
            "chunk": tpu["blend_chunk"]}
        self.map_backend_kwargs = dict(
            self.backend_kwargs,
            max_pairs_per_tile=tpu.get("map_max_pairs_per_tile",
                                       tpu["max_pairs_per_tile"]))

        color0, depth0, intrinsics0, pose0 = self.dataset[0]
        self.intrinsics = np.asarray(intrinsics0)[:3, :3]
        H, W = color0.shape[:2]
        self.cam = setup_camera(W, H, self.intrinsics)
        if self.sep_densify:
            _, _, dK, _ = self.densify_dataset[0]
            self.densify_cam = setup_camera(
                data_cfg["densification_image_width"],
                data_cfg["densification_image_height"], np.asarray(dK)[:3, :3])
        else:
            self.densify_cam = self.cam
        self.first_frame_w2c = np.linalg.inv(np.asarray(pose0, np.float64))

        self.sections: list[G.Section] = []
        self.traj = G.CameraTrajectory.create(self.num_frames, self.device)
        self.gt_w2c: list[np.ndarray] = [self.first_frame_w2c.copy()]
        self.map_draws = map_draws
        self.map_generator = torch.Generator().manual_seed(int(cfg["seed"]))
        self.ring_colors = torch.zeros((self.bfe, 3, H, W), device=self.device)
        self.ring_depths = torch.zeros((self.bfe, 1, H, W), device=self.device)
        self._bin_select = ("importance" if tpu.get("importance_binning", True)
                            else "depth")
        self.map_store = MapCacheStore(
            refresh=int(tpu.get("map_cache_refresh", 1)),
            select=self._bin_select)
        self.depth_means: list[float] = []     # far-depth filter statistics
        self.frame_times: dict[int, dict] = {}
        self.stats = {"tile_truncation_frac_max": 0.0}
        self._init_first_frame(color0, depth0)

    # ------------------------------------------------------------------
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stage(self, color_np, depth_np) -> Frame:
        color = torch.as_tensor(np.asarray(color_np, np.float32),
                                device=self.device)
        depth = torch.as_tensor(np.asarray(depth_np, np.float32),
                                device=self.device)
        return Frame(color=color.permute(2, 0, 1) / 255.0,
                     depth=depth.permute(2, 0, 1).contiguous())

    def _edge_mask_for(self, color_np, width, height) -> np.ndarray:
        mask = geometric_edge_mask(color_np.astype(np.uint8), dilate=True,
                                   RGB=True)
        return resize_mask_nearest(mask, width, height).astype(bool)

    def _loss_cfg(self, tracking: bool) -> LossConfig:
        tr = self.config["tracking" if tracking else "mapping"]
        bk = self.backend_kwargs if tracking else self.map_backend_kwargs
        return LossConfig(
            tracking=tracking, use_sil_for_loss=tr["use_sil_for_loss"],
            ignore_outlier_depth_loss=tr["ignore_outlier_depth_loss"],
            adaptive_sil=(tracking and self.dataset_name == "replica"
                          and tr["use_sil_for_loss"]),
            im_weight=float(tr["loss_weights"]["im"]),
            depth_weight=float(tr["loss_weights"]["depth"]),
            backend_kwargs=tuple(sorted(bk.items())))

    def _init_first_frame(self, color0, depth0):
        frame = self._stage(color0, depth0)
        parts = [first_frame_pointcloud(frame, self.cam)]
        dframe = (self._stage(*self.densify_dataset[0][:2])
                  if self.sep_densify else frame)
        dcam = self.densify_cam
        dmask = self._edge_mask_for(color0, dcam.width, dcam.height)
        parts.append(first_frame_pointcloud(
            dframe, dcam, mask=torch.as_tensor(dmask, device=self.device)))
        self._new_section_from_parts(parts, timestep=0.0,
                                     depth_max=float(frame.depth.max()))
        self._ring_write(0, frame)
        self._frame0 = frame

    def _new_section_from_parts(self, parts, timestep, depth_max):
        self.map_store.reset()
        pts = torch.cat([p[0] for p in parts])
        cols = torch.cat([p[1] for p in parts])
        msq = torch.cat([p[2] for p in parts])
        keep = torch.cat([p[3] for p in parts])
        n = int(keep.sum())
        cap = G.round_capacity(n, self.quantum)
        order = torch.argsort((~keep).to(torch.uint8), stable=True)

        def fit(x, fill=0.0):
            x = x[order]
            if cap <= x.shape[0]:
                return x[:cap].contiguous()
            return G.pad_rows(x, cap - x.shape[0], fill)

        sec = G.init_section(
            points=fit(pts), colors=fit(cols), mean3_sq_dist=fit(msq, 1.0),
            n_valid=n, capacity=cap, timestep=timestep,
            scene_radius=depth_max / self.config["scene_radius_depth_ratio"])
        self.sections.append(sec)

    def _ring_write(self, idx_in_sec: int, frame: Frame):
        self.ring_colors[idx_in_sec] = frame.color
        self.ring_depths[idx_in_sec] = frame.depth

    def _traj_write(self, t: int, q: torch.Tensor, tr: torch.Tensor):
        with torch.no_grad():
            self.traj.quats[t] = q
            self.traj.trans[t] = tr

    def _propagate_pose(self, t: int):
        """Constant-velocity pose init from frames t-1, t-2 (a copy of t-1
        at t == 1)."""
        q, tr = self.traj.quats, self.traj.trans
        if t <= 1:
            return q[t - 1].clone(), tr[t - 1].clone()
        w2c1 = geo.pose_to_w2c(geo.normalize(q[t - 1]), tr[t - 1])
        w2c2 = geo.pose_to_w2c(geo.normalize(q[t - 2]), tr[t - 2])
        w2c = geo.constant_velocity_init(w2c1, w2c2)
        return geo.rotmat_to_quat(w2c[:3, :3]), w2c[:3, 3]

    # ------------------------------------------------------------------
    def _update_pair_budget(self):
        tpu = self.config["tpu"]
        if not tpu.get("auto_pair_budget", True) or not self.sections:
            return
        tiles = (-(-self.cam.width // 16)) * (-(-self.cam.height // 16))
        n = max(s.n_active for s in self.sections)
        span = tpu["span_cap"]
        self.backend_kwargs["max_pairs_per_tile"] = auto_pair_budget(
            n, tiles, span, tpu["max_pairs_per_tile"])
        self.map_backend_kwargs["max_pairs_per_tile"] = auto_pair_budget(
            n, tiles, span,
            tpu.get("map_max_pairs_per_tile", tpu["max_pairs_per_tile"]))

    def _track(self, t: int, frame: Frame):
        """Tracking for one non-boundary frame; commits the best pose."""
        cfg = self.config
        tr = cfg["tracking"]
        self._update_pair_budget()
        bf_idx = t // self.bfe
        q0, tr0 = self._propagate_pose(t)
        self._traj_write(t, q0, tr0)

        far_mask = None
        if self.dataset_name != "replica":
            # far-depth filter: factor x mean of the 30 largest frame means
            d = frame.depth
            dm = float((d * (d > 0)).sum() / torch.clamp((d > 0).sum(), min=1))
            self.depth_means = sorted(self.depth_means + [dm])
            far_id = min(30, len(self.depth_means))
            far_thres = cfg["far_depth_factor"] * float(
                np.mean(self.depth_means[-far_id:]))
            far_mask = frame.depth[0] < far_thres

        num_iters = tr["num_iters"]
        if bf_idx == 0 and tr.get("base1_num_iters"):
            num_iters = tr["base1_num_iters"]
        tcfg = TrackingConfig(
            num_iters=num_iters, lr_quat=tr["lrs"]["cam_unnorm_rots"],
            lr_trans=tr["lrs"]["cam_trans"], metric="loss",
            loss_cfg=self._loss_cfg(True))
        sec = self.sections[bf_idx]
        state = init_track_state(q0, tr0, tr["sil_thres"])
        state = self._run_track(sec, state, frame, far_mask, tcfg)
        if tr["use_depth_loss_thres"] and float(state.depth_loss) >= \
                tr["depth_loss_thres"]:
            state = self._run_track(sec, state, frame, far_mask, tcfg)
        self._traj_write(t, state.best_quat, state.best_trans)
        return state

    def _run_track(self, sec, state, frame, aux_mask, tcfg):
        """The frozen-binning tracking loop, rebinned every
        tpu.track_rebin_every iterations when that is set; the generic
        loop when the cache route is off."""
        if not self.track_cached:
            state, _, _ = track_frame(sec.params, sec.active_mask(), state,
                                      frame, aux_mask, self.cam, tcfg)
            return state
        bk = self.backend_kwargs
        mpt = bk["max_pairs_per_tile"]
        rebin = int(self.config["tpu"].get("track_rebin_every", 0) or 0)
        total = tcfg.num_iters
        seg_lens = ([total] if rebin <= 0 or rebin >= total else
                    [rebin] * (total // rebin)
                    + ([total % rebin] if total % rebin else []))
        n_tiles = (-(-self.cam.height // 16)) * (-(-self.cam.width // 16))
        for seg in seg_lens:
            cache = build_track_cache(
                sec.params, sec.active_mask(), state.quat, state.trans,
                self.cam, span_cap=bk["span_cap"], max_pairs_per_tile=mpt,
                chunk=bk["chunk"], select=self._bin_select)
            state, _, _ = track_frame_cached(cache, state, frame, aux_mask,
                                             self.cam,
                                             tcfg._replace(num_iters=seg))
            trunc = float((cache.counts[:n_tiles] >= mpt).float().mean())
            self.stats["tile_truncation_frac_max"] = max(
                self.stats["tile_truncation_frac_max"], trunc)
        return state

    # ------------------------------------------------------------------
    def _pixel_candidates(self, idx, depth0_np, color_np, cam, quat, trans):
        dvals = depth0_np.reshape(-1)[idx].astype(np.float32)
        cols = color_np.reshape(-1, 3)[idx].astype(np.float32) / 255.0
        return densify_from_pixels(
            quat, trans, torch.as_tensor(dvals, device=self.device),
            torch.as_tensor(cols, device=self.device),
            torch.as_tensor(idx, device=self.device),
            torch.ones(len(idx), dtype=torch.bool, device=self.device), cam)

    def _densify(self, t, frame, edge_mask_np, color_np, depth_np) -> int:
        """Insert new Gaussians into the current section."""
        bf_idx = t // self.bfe
        sec = self.sections[bf_idx]
        quat, trans = self.traj.quats[t], self.traj.trans[t]
        npres = densify_nonpresence(
            sec.params, sec.active_mask(), quat, trans, frame, self.cam,
            self.config["mapping"]["sil_thres"],
            tuple(sorted(self.backend_kwargs.items())))
        np_np = npres.cpu().numpy()
        d0 = depth_np[..., 0]
        idx_b = np.flatnonzero(np_np & (d0 > 0))
        parts = [self._pixel_candidates(idx_b, d0, color_np, self.cam, quat,
                                        trans)]
        dcam = self.densify_cam
        np_mask = resize_mask_nearest(np_np.astype(np.uint8), dcam.width,
                                      dcam.height).astype(bool)
        e_mask = resize_mask_nearest(edge_mask_np.astype(np.uint8), dcam.width,
                                     dcam.height).astype(bool)
        if self.sep_densify:
            dcolor_np, ddepth_np = self.densify_dataset[t][:2]
        else:
            dcolor_np, ddepth_np = color_np, depth_np
        dd0 = np.asarray(ddepth_np)[..., 0]
        idx_s = np.flatnonzero(np_mask & e_mask & (dd0 > 0))
        parts.append(self._pixel_candidates(idx_s, dd0, np.asarray(dcolor_np),
                                            dcam, quat, trans))
        n_new = len(idx_b) + len(idx_s)
        need = sec.n_active + n_new
        if need > sec.capacity:
            sec = G.repad_section(sec, G.round_capacity(need, self.quantum))
        for c in parts:
            sec = G.append_gaussians(sec, c.points, c.colors, c.mean3_sq_dist,
                                     c.keep, float(t))
        self.sections[bf_idx] = sec
        return n_new

    # ------------------------------------------------------------------
    def _map(self, t: int, frame: Frame):
        """Mapping phase for one frame: over the section's keyframe caches
        on the binned route, else the generic route."""
        cfg = self.config
        mp = cfg["mapping"]
        self._update_pair_budget()
        bf_idx = t // self.bfe
        idx_in = t % self.bfe
        sec = self.sections[bf_idx]
        mcfg = MappingConfig(
            num_iters=mp["num_iters"],
            lrs=tuple(sorted((k, float(v)) for k, v in mp["lrs"].items()
                             if k not in ("cam_unnorm_rots", "cam_trans"))),
            loss_cfg=self._loss_cfg(False), use_global=False)
        if not self.map_binned:
            new_params = self._map_generic(t, frame, sec, mcfg)
        else:
            mbk = self.map_backend_kwargs
            W = min(self.bfe, int(cfg["tpu"].get("map_cache_slots", 64)))
            slots, slot_ids, count = self.map_store.update(
                sec.params, sec.active_mask(), sec.n_active, idx_in,
                self.traj.quats[t].clone(), self.traj.trans[t].clone(),
                self.cam, mbk["span_cap"], mbk["max_pairs_per_tile"], W)
            kf = KeyframeBuffer(colors=self.ring_colors,
                                depths=self.ring_depths, count=count)
            draws = (self.map_draws(t, mcfg.num_iters, count)
                     if self.map_draws is not None else None)
            new_params, _ = map_frame_binned(sec.params, kf, slots, slot_ids,
                                             self.cam, mcfg, draws=draws,
                                             generator=self.map_generator)
        self.sections[bf_idx] = sec.replace(params=new_params)

    def _map_generic(self, t: int, frame: Frame, sec, mcfg: MappingConfig):
        """The generic mapping loop over the frame alone at a section's
        first frame, else over the section's ring up to the frame."""
        idx_in = t % self.bfe
        if idx_in == 0:
            ids = torch.tensor([t], device=self.device)
            colors, depths, count = frame.color[None], frame.depth[None], 1
        else:
            ids = torch.clamp(torch.arange(self.bfe, device=self.device)
                              + (t - idx_in), max=self.num_frames - 1)
            colors, depths = self.ring_colors, self.ring_depths
            count = idx_in + 1
        kf = KeyframeBuffer(colors=colors, depths=depths, count=count,
                            quats=self.traj.quats[ids].clone(),
                            trans=self.traj.trans[ids].clone())
        draws = (self.map_draws(t, mcfg.num_iters, count)
                 if self.map_draws is not None else None)
        new_params, _ = map_frame(sec.params, sec.active_mask(), kf, self.cam,
                                  mcfg, draws=draws,
                                  generator=self.map_generator)
        return new_params

    # ------------------------------------------------------------------
    def process_frame_zero(self):
        """Frame 0: no tracking; map the freshly initialized section."""
        t0 = time.time()
        if self.config["mapping"]["num_iters"] > 0:
            self._map(0, self._frame0)
        self._sync()
        self.frame_times[0] = {"track": 0.0, "densify": 0.0,
                               "map": time.time() - t0}

    def process_frame(self, t: int):
        if t == 0:
            return self.process_frame_zero()
        if t >= self.bfe:
            raise NotImplementedError(BOUNDARY_MSG)
        cfg = self.config
        color_np, depth_np, _, gt_pose = self.dataset[t]
        frame = self._stage(color_np, depth_np)
        gt_w2c = np.linalg.inv(np.asarray(gt_pose, np.float64))
        self.gt_w2c.append(gt_w2c)
        times = {"track": 0.0, "densify": 0.0, "map": 0.0}

        t0 = time.time()
        if not cfg["tracking"]["use_gt_poses"]:
            self._track(t, frame)
        else:
            quat, trans = geo.w2c_to_pose(
                torch.as_tensor(gt_w2c, dtype=torch.float32, device=self.device))
            self._traj_write(t, quat, trans)
        self._sync()
        times["track"] = time.time() - t0
        self._ring_write(t % self.bfe, frame)

        if (t + 1) % cfg["map_every"] == 0:
            if cfg["mapping"]["add_new_gaussians"]:
                t0 = time.time()
                edge_np = self._edge_mask_for(color_np, self.cam.width,
                                              self.cam.height)
                self._densify(t, frame, edge_np, color_np, depth_np)
                self._sync()
                times["densify"] = time.time() - t0
            if cfg["mapping"]["num_iters"] > 0:
                t0 = time.time()
                self._map(t, frame)
                self._sync()
                times["map"] = time.time() - t0
        self.frame_times[t] = times

    def run(self, num_frames: int | None = None):
        """Frames 0 .. min(num_frames, baseframe_every) - 1."""
        n = min(num_frames or self.num_frames, self.num_frames, self.bfe)
        self.process_frame_zero()
        for t in range(1, n):
            self.process_frame(t)
        return self

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate_frame(self, t: int) -> tuple[float, float]:
        """(PSNR dB, depth L1 m) of the render at the committed pose, as the
        JAX package's eval_sequence computes them."""
        color_np, depth_np, _, _ = self.dataset[t]
        sec = self.sections[t // self.bfe]
        bk = eval_backend_kwargs(sec.n_active, self.cam.height, self.cam.width,
                                 self.config["tpu"])
        r = render_slam(sec.params, sec.active_mask(), self.traj.quats[t],
                        self.traj.trans[t], self.cam, bk)
        gt_im = np.transpose(color_np, (2, 0, 1)) / 255.0
        gt_depth = np.transpose(depth_np, (2, 0, 1))
        valid = gt_depth > 0
        im = r.im.cpu().numpy()
        psnr = float(calc_psnr(im * valid, gt_im * valid).mean())
        diff = r.depth.cpu().numpy() * valid - gt_depth
        l1 = float((np.abs(diff) * valid).sum() / max(valid.sum(), 1))
        return psnr, l1

    def ate(self, num_frames: int) -> float:
        """Mean translational error (Horn-aligned) over frames processed."""
        est = [self.first_frame_w2c]
        for t in range(1, num_frames):
            w2c = geo.pose_to_w2c(geo.normalize(self.traj.quats[t]),
                                  self.traj.trans[t])
            est.append(w2c.detach().cpu().numpy().astype(np.float64))
        return evaluate_ate([np.linalg.inv(x) for x in self.gt_w2c[:num_frames]],
                            [np.linalg.inv(x) for x in est])
