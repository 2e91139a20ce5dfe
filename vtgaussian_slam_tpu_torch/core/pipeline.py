"""The online SLAM engine: tracking -> densification -> mapping per frame,
one view-tied Gaussian section per base frame.

Parity: `vtgaussian_slam_tpu/core/pipeline.py` (`VTGaussianSLAM`). Frame 0
seeds the first section from the back-projected frame plus the
Canny-masked densification stream and maps it; every later frame tracks
(constant-velocity init), densifies on a fresh render (K4) and maps. Every
`baseframe_every` frames a boundary:

  - selects the sections that overlap the frame (core/selection.py: the
    replica 1600-pixel pool scoring and earliest-chain walk, or the
    tum/scannet all-pixel visibility scoring over the base-frame pool);
  - tracks against the chosen section, keeping the candidate with the
    lowest point-to-plane distance to the overlap frame (core/p2p.py);
    tum/scannet first run 31 iterations per candidate section by loss;
  - spawns a new section from the frame at the tracked pose (no
    densification on that frame);

and every later mapping phase of the section adds the global-consistency
term against two frozen sections (core/mapping.py). Sections outside the
hot set {current} U fixed_section_ids move to pinned host memory on a side
CUDA stream and come back on first use.

Tracking and mapping each take one of two routes, chosen as the JAX engine
chooses them:

  - tracking: the frozen-binning cache (K1 + K2) for isotropic configs
    with `tpu.track_cache` on (the default); otherwise the generic route,
    which renders from scratch every iteration (K4, backward K5);
  - mapping: the per-keyframe frozen binnings (K1 + K3; the global term
    through one binning of the concat) for isotropic configs whose
    means3D / unnorm_rotations mapping lrs are zero, with `tpu.map_binned`
    on (its default is on for CUDA and off for the CPU, as the JAX default
    follows the backend); otherwise the generic route.

As in the JAX engine, `gaussian_distribution="anisotropic"` changes the
route but not the Gaussians: sections are seeded with (N, 1) log-scales
either way. The pair budget follows `auto_pair_budget` times a boost that
the measured truncation harm (map_cache.trunc_probe) drives.

Frames come from the real-data loaders or the synthetic generator
(`build_dataset`) through a `FramePrefetcher`, whose threads decode the
next frames while the engine works on the current one.
`export_params_ls` gives the reference's params_ls.

Random draws (mapping keyframes, the 1600 selection pixels) come from
host `torch.Generator`s; tests inject the JAX engine's draws through the
`map_draws` and `overlap_ranks` hooks. The engine runs on CUDA unless the
caller passes device="cpu".
"""
from __future__ import annotations

import os
import time
from typing import Callable

import numpy as np
import torch

from ..datasets import get_dataset, load_dataset_config
from ..datasets.prefetch import FramePrefetcher
from ..eval.evaluate import eval_pair_budget, frame_metrics
from ..eval.metrics import evaluate_ate
from ..models import gaussians as G
from ..ops import geometry as geo
from ..ops.camera import setup_camera
from ..ops.image import geometric_edge_mask, resize_mask_nearest
from ..utils.common import resolve_device
from .config import (auto_pair_budget, prepare_config,
                     separate_densification_res)
from .densify import (base_frame_pointcloud, densify_from_pixels,
                      densify_nonpresence, first_frame_pointcloud)
from .losses import Frame, LossConfig, render_slam
from .map_cache import MapCacheStore, build_global_cache, trunc_probe
from .mapping import KeyframeBuffer, MappingConfig, map_frame, map_frame_binned
from .p2p import P2PTarget, make_p2p_target
from .selection import (find_earliest_keyframe, overlap_percents,
                        select_earliest_topk_base, select_topk_overlap,
                        select_visbased)
from .track_cache import build_track_cache
from .tracking import (TrackingConfig, init_track_state, track_frame,
                       track_frame_cached)

# cumulative seconds in `stats` that `frame_times[t]["timers"]` splits per
# frame: the boundary work, the paging, and the frame's load and staging
TIMER_KEYS = ("t_select", "t_sel_pool", "t_sel_walk", "t_prefetch",
              "t_track_prep", "t_track_cache", "t_spawn", "t_map_select",
              "t_global_concat", "t_global_cache", "t_map_store", "t_page",
              "t_page_in", "t_page_fin", "t_dataset", "t_stage")


def gradslam_config(data_cfg: dict) -> dict:
    """The dataset's gradslam config: the YAML that `gradslam_data_cfg`
    names, else just the config's `dataset_name`."""
    if "gradslam_data_cfg" not in data_cfg:
        return {"dataset_name": data_cfg["dataset_name"]}
    return load_dataset_config(data_cfg["gradslam_data_cfg"])


def build_dataset(config: dict, densify_res: bool = False):
    """The dataset of a config, at the tracking resolution or at the
    densification stream's; shared by the engine and eval_mode."""
    config = prepare_config(config)
    data_cfg = config["data"]
    gradslam_cfg = gradslam_config(data_cfg)
    if "synthetic" in data_cfg:
        gradslam_cfg["synthetic"] = data_cfg["synthetic"]
    hw_key = "densification_image" if densify_res else "desired_image"
    return get_dataset(
        config_dict=gradslam_cfg, basedir=data_cfg.get("basedir", ""),
        sequence=os.path.basename(str(data_cfg.get("sequence", ""))),
        start=data_cfg.get("start", 0), end=data_cfg.get("end", -1),
        stride=data_cfg.get("stride", 1),
        desired_height=data_cfg[f"{hw_key}_height"],
        desired_width=data_cfg[f"{hw_key}_width"], relative_pose=True,
        ignore_bad=data_cfg["ignore_bad"],
        use_train_split=data_cfg["use_train_split"])


class BaseframeStore:
    """The candidate pool for overlap selection: per base frame its id,
    pose and depth, the depth stored SUBSAMPLED by `stride` (exact strided
    samples, so values stay metric for the depth-consistency test). Rows
    grow by `quantum`; scoring reads the live prefix padded to `rung()`."""

    def __init__(self, H: int, W: int, quantum: int = 64, stride: int = 4,
                 device="cuda"):
        self.quantum = quantum
        self.stride = max(int(stride), 1)
        self.sH = -(-H // self.stride)
        self.sW = -(-W // self.stride)
        self.ids: list[int] = []
        self.depths = torch.zeros((quantum, self.sH, self.sW), device=device)
        self.quats = torch.zeros((quantum, 4), device=device)
        self.trans = torch.zeros((quantum, 3), device=device)

    def append(self, frame_id: int, depth: torch.Tensor, quat: torch.Tensor,
               trans: torch.Tensor):
        i = len(self.ids)
        if i >= self.depths.shape[0]:
            self.depths = G.pad_rows(self.depths, self.quantum)
            self.quats = G.pad_rows(self.quats, self.quantum)
            self.trans = G.pad_rows(self.trans, self.quantum)
        with torch.no_grad():
            self.depths[i] = depth[::self.stride, ::self.stride]
            self.quats[i] = quat
            self.trans[i] = trans
        self.ids.append(frame_id)

    def w2cs(self, rung: int | None = None) -> torch.Tensor:
        q = self.quats if rung is None else self.quats[:rung]
        t = self.trans if rung is None else self.trans[:rung]
        return geo.pose_to_w2c(geo.normalize(q), t)

    def rung(self) -> int:
        """The live entry count rounded up to a power of two (min 8, at
        most the rows held): the rows the scorer reads."""
        b = max(len(self.ids), 1)
        return min(max(8, 1 << (b - 1).bit_length()), self.depths.shape[0])

    def __len__(self):
        return len(self.ids)


class VTGaussianSLAM:
    """Hooks (tests inject the JAX engine's draws through them):
    map_draws(t, num_iters, count) -> keyframe indices (cache slots on the
    binned route) for frame t's mapping phase; overlap_ranks(t) -> the
    1600 pixel ranks of frame t's next sampled overlap scoring."""

    def __init__(self, config: dict, device="cuda",
                 map_draws: Callable[[int, int, int], list] | None = None,
                 overlap_ranks: Callable[[int], list] | None = None):
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

        self.dataset_name = gradslam_config(data_cfg)["dataset_name"]
        if self.dataset_name == "synthetic" and cfg.get("selection_style"):
            # a synthetic proxy runs its scene family's selection
            self.dataset_name = cfg["selection_style"]
        if self.dataset_name == "scannetpp":
            raise NotImplementedError("ScanNet++ odometry: later slice")

        lookahead = tpu.get("prefetch", 2)
        self.dataset = FramePrefetcher(build_dataset(cfg), lookahead=lookahead)
        self.sep_densify = separate_densification_res(cfg)
        self.densify_dataset = (
            FramePrefetcher(build_dataset(cfg, densify_res=True),
                            lookahead=lookahead)
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
        self.K = torch.as_tensor(self.intrinsics, dtype=torch.float32,
                                 device=self.device)
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
        self.overlap_ranks = overlap_ranks
        self.map_generator = torch.Generator().manual_seed(int(cfg["seed"]))
        self.select_generator = torch.Generator().manual_seed(
            int(cfg["seed"]) + 1)
        self.ring_colors = torch.zeros((self.bfe, 3, H, W), device=self.device)
        self.ring_depths = torch.zeros((self.bfe, 1, H, W), device=self.device)
        self._bin_select = ("importance" if tpu.get("importance_binning", True)
                            else "depth")
        self.map_store = MapCacheStore(
            refresh=int(tpu.get("map_cache_refresh", 1)),
            select=self._bin_select)
        self.baseframes = BaseframeStore(
            H, W, tpu["baseframe_capacity_quantum"],
            stride=int(tpu.get("baseframe_depth_stride", 4)),
            device=self.device)
        self.tracking_corr: list[list] = []
        self.earliest_corr: list[list] = []
        self.mapping_corr: list[list] = []
        self.fixed_section_ids: tuple[int, int] | None = None
        self.section_ids: dict[int, int] = {}   # frame -> section tracked on
        self.depth_means: list[float] = []      # far-depth filter statistics
        self._depth_lru: dict[int, np.ndarray] = {}
        self._gcache = self._gcache_key = None
        self._gcache_age = 0
        # closed-loop pair budget (_run_track / _update_pair_budget)
        self._mpt_boost = 1
        self._pending_harm = None
        self._pending_harm_mpt = None
        self._harm_hist: list[float] = []
        self._frames_tracked = 0
        self.probe_log: list[tuple] = []    # (mpt, reading, boost after)
        # section paging (_page_cold_sections)
        self.section_paging = bool(tpu.get("section_paging", True))
        self._page_pending: dict[int, tuple] = {}   # copies in flight
        self._paged: dict[int, object] = {}         # on the host: its event
        self._page_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self.frame_times: dict[int, dict] = {}
        self.frames_done = 0    # frames 0 .. frames_done - 1 processed
        self.stats = {
            "tracking_iter_time_sum": 0.0, "tracking_iter_count": 0,
            "tracking_frame_time_sum": 0.0, "tracking_frame_count": 0,
            "tracking_loop_time_sum": 0.0, "tracking_loop_iters": 0,
            "mapping_iter_time_sum": 0.0, "mapping_iter_count": 0,
            "mapping_frame_time_sum": 0.0, "mapping_frame_count": 0,
            "mapping_loop_time_sum": 0.0, "mapping_loop_iters": 0,
            "tile_truncation_frac_max": 0.0, "trunc_probe_diff_max": 0.0,
            "section_page_ins": 0, "section_prefetched_ins": 0,
            "section_page_outs": 0, "t_densify": 0.0,
            **{k: 0.0 for k in TIMER_KEYS}}
        self._init_first_frame(color0, depth0)

    # ------------------------------------------------------------------
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _upload(self, x_np) -> torch.Tensor:
        """A host array as a float32 tensor on the device; to a card
        through pinned memory without waiting for the stream."""
        x = torch.from_numpy(np.ascontiguousarray(x_np, np.float32))
        if self.device.type != "cuda":
            return x
        return x.pin_memory().to(self.device, non_blocking=True)

    def _stage(self, color_np, depth_np) -> Frame:
        color = self._upload(color_np)
        depth = self._upload(depth_np)
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
        self._remember_depth(0, np.asarray(depth0)[..., 0].astype(np.float32))

    def _new_section_from_parts(self, parts, timestep, depth_max):
        self.map_store.reset()      # the caches belong to the old section
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

    def _new_base_section(self, t: int, frame: Frame, color_np):
        """Spawn the view-tied section of boundary frame t at its tracked
        pose: the frame and the Canny-masked densification stream."""
        w2c = self._traj_w2c(t)
        parts = [base_frame_pointcloud(frame, self.cam, w2c)]
        dframe = (self._stage(*self.densify_dataset[t][:2])
                  if self.sep_densify else frame)
        dcam = self.densify_cam
        dmask = self._edge_mask_for(color_np, dcam.width, dcam.height)
        parts.append(base_frame_pointcloud(
            dframe, dcam, w2c, mask=torch.as_tensor(dmask, device=self.device)))
        self._new_section_from_parts(parts, timestep=float(t),
                                     depth_max=float(frame.depth.max()))

    def _ring_write(self, idx_in_sec: int, frame: Frame):
        self.ring_colors[idx_in_sec] = frame.color
        self.ring_depths[idx_in_sec] = frame.depth

    def _traj_write(self, t: int, q: torch.Tensor, tr: torch.Tensor):
        with torch.no_grad():
            self.traj.quats[t] = q
            self.traj.trans[t] = tr

    def _traj_w2c(self, t: int) -> torch.Tensor:
        return geo.pose_to_w2c(geo.normalize(self.traj.quats[t]),
                               self.traj.trans[t])

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

    def _dataset_depth(self, fid: int) -> np.ndarray:
        """(H, W) depth of a past frame from a 32-entry LRU that every
        processed frame seeds, for the boundary targets and masks."""
        d = self._depth_lru.pop(fid, None)
        if d is None:
            _, depth, _, _ = self.dataset[fid]
            d = np.asarray(depth)[..., 0].astype(np.float32)
        self._remember_depth(fid, d)
        return d

    def _remember_depth(self, fid: int, d: np.ndarray):
        self._depth_lru[fid] = d
        while len(self._depth_lru) > 32:
            self._depth_lru.pop(next(iter(self._depth_lru)))

    def _depth_of(self, fid: int) -> torch.Tensor:
        return torch.as_tensor(self._dataset_depth(fid), device=self.device)

    # ------------------------------------------------------------------
    def _update_pair_budget(self):
        """Re-bucket max_pairs_per_tile to the densest section, after
        reading the pending truncation probe: boost x2 when the last two
        readings were both above 1% of pixels, /2 when the last four were
        all below 0.2%; the history clears on each change."""
        tpu = self.config["tpu"]
        if not tpu.get("auto_pair_budget", True) or not self.sections:
            return
        if self._pending_harm is not None:
            harm = float(self._pending_harm)
            self._pending_harm = None
            self.stats["trunc_probe_diff_max"] = max(
                self.stats["trunc_probe_diff_max"], harm)
            self._harm_hist.append(harm)
            if (len(self._harm_hist) >= 2 and self._mpt_boost < 64
                    and all(h > 0.01 for h in self._harm_hist[-2:])):
                self._mpt_boost *= 2
                self._harm_hist.clear()
                print(f"[auto_pair_budget] measured truncation harm "
                      f"{harm:.4f} at mpt={self._pending_harm_mpt}; "
                      f"boost -> {self._mpt_boost}")
            elif (len(self._harm_hist) >= 4 and self._mpt_boost > 1
                    and all(h < 0.002 for h in self._harm_hist[-4:])):
                self._mpt_boost //= 2
                self._harm_hist.clear()
                print(f"[auto_pair_budget] probe clean at "
                      f"mpt={self._pending_harm_mpt}; boost decays -> "
                      f"{self._mpt_boost}")
            del self._harm_hist[:-4]
            self.probe_log.append((self._pending_harm_mpt, harm,
                                   self._mpt_boost))
        tiles = (-(-self.cam.width // 16)) * (-(-self.cam.height // 16))
        n = max(int(s.n_active) for s in self.sections)
        span = tpu["span_cap"]
        self.backend_kwargs["max_pairs_per_tile"] = auto_pair_budget(
            n, tiles, span, tpu["max_pairs_per_tile"], boost=self._mpt_boost)
        self.map_backend_kwargs["max_pairs_per_tile"] = auto_pair_budget(
            n, tiles, span,
            tpu.get("map_max_pairs_per_tile", tpu["max_pairs_per_tile"]),
            boost=self._mpt_boost)

    # ------------------------------------------------------------------
    def _select_boundary_sections(self, t: int, frame: Frame,
                                  cand_w2c: torch.Tensor):
        """The candidate sections to track boundary frame t against, and
        the overlap frame id whose geometry the p2p metric reads."""
        cfg = self.config
        tr = cfg["tracking"]
        bf_idx = t // self.bfe
        bfs = self.baseframes
        rung = bfs.rung()
        if self.dataset_name == "replica":
            # one 1600-pixel pool scoring per boundary, read by both the
            # top-overlap pick and the chain walk
            t0 = time.time()
            B = len(bfs)
            pct = overlap_percents(
                frame.depth[0], cand_w2c, self.K, bfs.w2cs(rung),
                bfs.depths[:rung], ranks=self._ranks(t), pixels=1600,
                edge=tr["edge"], use_vis=False,
                generator=self.select_generator).cpu().numpy()
            if bf_idx == 1:
                top_time = 0
            else:
                sel = select_topk_overlap(pct[:B], 1)
                top_time = bfs.ids[sel[-1]] if sel else 0
            self.tracking_corr.append([top_time, (bf_idx - 1) * self.bfe, t])
            self.stats["t_sel_pool"] += time.time() - t0
            t0 = time.time()
            earliest = find_earliest_keyframe(
                self.tracking_corr, lambda i: float(pct[i]), self.bfe,
                tr["keyframe_thresh"])
            self.earliest_corr.append([earliest, None, t])
            self.stats["t_sel_walk"] += time.time() - t0
            return [earliest // self.bfe], earliest

        # tum / scannet (and plain synthetic): all-pixel visibility scoring
        # over the pool less the newest base frames, earliest top-k sections
        ignore = int(self.bfe / cfg["overlap_every"])
        pool = max(len(bfs) - (ignore - 1), 1)
        t0 = time.time()
        pct = overlap_percents(
            frame.depth[0], cand_w2c, self.K, bfs.w2cs(rung),
            bfs.depths[:rung], pixels=0, edge=tr["edge"], use_vis=True,
            kf_depth_thresh=tr["kf_depth_thresh"],
            depth_stride=bfs.stride).cpu().numpy()
        self.stats["t_sel_pool"] += time.time() - t0
        topk = None if bf_idx <= 2 else tr["topk_base"]
        secs = select_earliest_topk_base(
            pct[:pool], cfg, tr["earliest_thres"],
            tr["lower_earliest_thres_percent"], topk)
        self.earliest_corr.append([t, "selected_baseframes", secs])
        return secs, secs[0] * self.bfe

    def _ranks(self, t: int):
        return self.overlap_ranks(t) if self.overlap_ranks is not None else None

    def _overlap_p2p_target(self, frame_id: int) -> P2PTarget:
        return make_p2p_target(self._depth_of(frame_id)[None], self.K,
                               self._traj_w2c(frame_id))

    @torch.no_grad()
    def _boundary_vis_mask(self, t: int, frame: Frame, state,
                           chosen_base: int) -> torch.Tensor:
        """Union of the depth-consistency visibility masks of the frame at
        the current pose iterate against the chosen section's first frame
        (tum) or first, middle and last frames (scannet)."""
        H, W = self.cam.height, self.cam.width
        curr_w2c = geo.pose_to_w2c(geo.normalize(state.quat), state.trans)
        pts = geo.backproject(frame.depth[0], self.K,
                              c2w=geo.invert_se3(curr_w2c), depth_factor=1.0,
                              pixel_center=0.0)
        ids = [chosen_base]
        if self.dataset_name == "scannet":
            ids += [chosen_base + self.bfe // 2, chosen_base + self.bfe - 1]
        mask = torch.zeros((H * W,), dtype=torch.bool, device=self.device)
        thres = self.config["tracking"]["vis_mask_thres"]
        for fid in ids:
            fid = min(fid, t - 1)
            mask = mask | geo.visibility_mask(pts, self._traj_w2c(fid),
                                              self.K, self._depth_of(fid),
                                              thres)
        return mask.reshape(H, W)

    def _track(self, t: int, frame: Frame) -> int:
        """Tracking for one frame; commits the best pose and returns the
        section it tracked against."""
        cfg = self.config
        tr = cfg["tracking"]
        t_host0 = time.time()
        self._update_pair_budget()
        bf_idx = t // self.bfe
        boundary = t % self.bfe == 0
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
        sil_thres = tr["sil_thres"]
        if boundary and tr.get("sil_thres_base") is not None:
            sil_thres = tr["sil_thres_base"]

        def tcfg_of(n, metric):
            return TrackingConfig(
                num_iters=n, lr_quat=tr["lrs"]["cam_unnorm_rots"],
                lr_trans=tr["lrs"]["cam_trans"], metric=metric,
                p2p_method=tr["p2p_method"], loss_cfg=self._loss_cfg(True))

        at_boundary = boundary and bf_idx >= 1
        if at_boundary:
            t0 = time.time()
            cand_secs, overlap_frame = self._select_boundary_sections(
                t, frame, self._traj_w2c(t))
            self.stats["t_select"] += time.time() - t0
            t0 = time.time()
            self._prefetch_sections(cand_secs)
            self.stats["t_prefetch"] += time.time() - t0
        else:
            cand_secs, overlap_frame = [min(bf_idx, len(self.sections) - 1)], None

        t_start = time.time()
        self.stats["t_track_prep"] += t_start - t_host0
        t_prep = 0.0       # boundary prep inside the timed window
        if at_boundary and self.dataset_name in ("tum", "scannet"):
            # phase 1: each candidate section for up to 31 iterations by
            # loss; the lowest min_loss wins
            phase1 = tcfg_of(min(31, num_iters), "loss")
            states = []
            for sec_id in cand_secs:
                st = init_track_state(q0, tr0, sil_thres)
                states.append(self._run_track(self._sec(sec_id), st, frame,
                                              far_mask, None, phase1))
            win = int(np.argmin([float(s.min_loss) for s in states]))
            sec_id, state = cand_secs[win], states[win]
            # phase 2: visibility-masked loss, candidates by p2p
            t0 = time.time()
            chosen_base = sec_id * self.bfe
            aux = self._boundary_vis_mask(t, frame, state, chosen_base)
            if far_mask is not None:
                aux = aux & far_mask
            p2p_t = self._overlap_p2p_target(chosen_base)
            t_prep = time.time() - t0
            self.stats["t_track_prep"] += t_prep
            state.min_metric = torch.full_like(state.min_metric, 1e20)
            n2 = max(num_iters - phase1.num_iters, 0)
            if n2 > 0:
                state = self._run_track(self._sec(sec_id), state, frame, aux,
                                        p2p_t, tcfg_of(n2, "p2p"))
        else:
            metric, p2p_t = "loss", None
            if at_boundary and self.dataset_name == "replica":
                t0 = time.time()
                metric = "p2p"
                p2p_t = self._overlap_p2p_target(overlap_frame)
                t_prep = time.time() - t0
                self.stats["t_track_prep"] += t_prep
            tcfg = tcfg_of(num_iters, metric)
            sec_id = cand_secs[0]
            sec = self._sec(sec_id)
            state = init_track_state(q0, tr0, sil_thres)
            state = self._run_track(sec, state, frame, far_mask, p2p_t, tcfg)
            if tr["use_depth_loss_thres"] and float(state.depth_loss) >= \
                    tr["depth_loss_thres"]:
                state = self._run_track(sec, state, frame, far_mask, p2p_t,
                                        tcfg)

        self._sync()
        dt = time.time() - t_start - t_prep
        self.stats["tracking_frame_time_sum"] += dt
        self.stats["tracking_frame_count"] += 1
        two_phase = at_boundary and self.dataset_name in ("tum", "scannet")
        total_iters = num_iters * (max(1, len(cand_secs)) if two_phase else 1)
        self.stats["tracking_iter_time_sum"] += dt
        self.stats["tracking_iter_count"] += max(total_iters, 1)
        self._traj_write(t, state.best_quat, state.best_trans)
        return sec_id

    def _run_track(self, sec, state, frame, aux_mask, p2p_t, tcfg):
        """The frozen-binning tracking loop, rebinned every
        tpu.track_rebin_every iterations when that is set, then the
        truncation probe at the best pose on its cadence; the generic loop
        when the cache route is off."""
        if not self.track_cached:
            t0 = time.time()
            state, _, _ = track_frame(sec.params, sec.active_mask(), state,
                                      frame, aux_mask, self.cam, tcfg, p2p_t)
            self._sync()
            self.stats["tracking_loop_time_sum"] += time.time() - t0
            self.stats["tracking_loop_iters"] += tcfg.num_iters
            return state
        tpu = self.config["tpu"]
        bk = self.backend_kwargs
        mpt = bk["max_pairs_per_tile"]
        rebin = int(tpu.get("track_rebin_every", 0) or 0)
        total = tcfg.num_iters
        seg_lens = ([total] if rebin <= 0 or rebin >= total else
                    [rebin] * (total // rebin)
                    + ([total % rebin] if total % rebin else []))
        n_tiles = (-(-self.cam.height // 16)) * (-(-self.cam.width // 16))
        for seg in seg_lens:
            t0 = time.time()
            cache = build_track_cache(
                sec.params, sec.active_mask(), state.quat, state.trans,
                self.cam, span_cap=bk["span_cap"], max_pairs_per_tile=mpt,
                chunk=bk["chunk"], select=self._bin_select)
            self.stats["t_track_cache"] += time.time() - t0
            t0 = time.time()
            state, _, _ = track_frame_cached(cache, state, frame, aux_mask,
                                             self.cam,
                                             tcfg._replace(num_iters=seg),
                                             p2p_t)
            self._sync()
            self.stats["tracking_loop_time_sum"] += time.time() - t0
            self.stats["tracking_loop_iters"] += seg
            trunc = float((cache.counts[:n_tiles] >= mpt).double().mean())
            self.stats["tile_truncation_frac_max"] = max(
                self.stats["tile_truncation_frac_max"], trunc)
        if tpu.get("auto_pair_budget", True):
            # the measured harm at the best pose, read on the next frame
            # (no wait here): every frame until two readings exist, then
            # every tpu.trunc_probe_every frames
            every = max(1, int(tpu.get("trunc_probe_every", 10)))
            if len(self._harm_hist) < 2 or self._frames_tracked % every == 0:
                self._pending_harm = trunc_probe(
                    sec.params, sec.active_mask(), state.best_quat,
                    state.best_trans, self.cam, span_cap=bk["span_cap"],
                    mpt=mpt, select=self._bin_select)
                self._pending_harm_mpt = mpt
        self._frames_tracked += 1
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
        sec = self._sec(bf_idx)
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
    def _select_mapping_overlap(self, t: int, frame: Frame) -> int:
        """The overlapping older section whose frozen copy joins the
        global term from boundary frame t on (section 0 at the first
        boundary)."""
        bf_idx = t // self.bfe
        if bf_idx == 1:
            return 0
        cfg = self.config
        bfs = self.baseframes
        rung = bfs.rung()
        if self.dataset_name == "replica":
            B = len(bfs) - 1
            pct = overlap_percents(
                frame.depth[0], self._traj_w2c(t), self.K, bfs.w2cs(rung),
                bfs.depths[:rung], ranks=self._ranks(t), pixels=1600,
                edge=cfg["tracking"]["edge"], use_vis=False,
                generator=self.select_generator).cpu().numpy()
            sel = select_topk_overlap(pct[:B], 1)
            return bfs.ids[sel[-1]] // self.bfe if sel else 0
        ignore = int(self.bfe / cfg["overlap_every"])
        pool = max(len(bfs) - ignore, 1)
        pct = overlap_percents(
            frame.depth[0], self._traj_w2c(t), self.K, bfs.w2cs(rung),
            bfs.depths[:rung], pixels=0, edge=cfg["tracking"]["edge"],
            use_vis=True, kf_depth_thresh=cfg["tracking"]["kf_depth_thresh"],
            depth_stride=bfs.stride).cpu().numpy()
        sel, _ = select_visbased(pct[:pool], 1)
        return bfs.ids[sel[0]] // self.bfe if sel else 0

    def _fixed_concat(self):
        """The two frozen sections fused into one buffer (params, active)."""
        t0 = time.time()
        fixed, _ = G.concat_sections(
            [self._sec(i) for i in self.fixed_section_ids],
            quantum=self.quantum)
        self.stats["t_global_concat"] += time.time() - t0
        return fixed.params, fixed.active_mask()

    def _global_cache(self, sec, active, start: int, mpt: int, span_cap: int):
        """The global binning of [fixed sections; section] at the section's
        base keyframe, rebuilt when its key changes or every
        tpu.global_cache_refresh_every frames; its pair budget is sized from
        the concat's count."""
        t0 = time.time()
        refresh_every = int(
            self.config["tpu"].get("global_cache_refresh_every", 4))
        sizes = [int(self._sec(i).n_active) for i in self.fixed_section_ids]
        fixed_cap = G.round_capacity(sum(sizes), self.quantum)
        gkey = (self.fixed_section_ids, sec.capacity, fixed_cap, mpt,
                self._mpt_boost, start)
        if (self._gcache is None or self._gcache_key != gkey
                or self._gcache_age >= refresh_every):
            self._gcache = None     # free the old binning first
            fixed_params, fixed_active = self._fixed_concat()
            tiles = (-(-self.cam.width // 16)) * (-(-self.cam.height // 16))
            g_mpt = auto_pair_budget(sec.n_active + sum(sizes), tiles,
                                     span_cap, mpt, boost=self._mpt_boost)
            gc = build_global_cache(
                fixed_params, fixed_active, sec.params, active,
                self.traj.quats[start].clone(), self.traj.trans[start].clone(),
                self.cam, span_cap=span_cap, max_pairs_per_tile=g_mpt,
                select=self._bin_select)
            g_trunc = float((gc.counts[:tiles] >= g_mpt).double().mean())
            self.stats["tile_truncation_frac_max"] = max(
                self.stats["tile_truncation_frac_max"], g_trunc)
            self._gcache, self._gcache_key, self._gcache_age = gc, gkey, 1
        else:
            self._gcache_age += 1
        self.stats["t_global_cache"] += time.time() - t0
        return self._gcache

    def _map(self, t: int, frame: Frame):
        """Mapping phase for one frame: over the section's keyframe caches
        on the binned route, else the generic route; with the global term
        once a boundary has fixed the frozen sections."""
        cfg = self.config
        mp = cfg["mapping"]
        self._update_pair_budget()
        bf_idx = t // self.bfe
        idx_in = t % self.bfe
        t_start = time.time()
        if idx_in == 0 and bf_idx != 0:
            t0 = time.time()
            overlap_sec = self._select_mapping_overlap(t, frame)
            self.fixed_section_ids = (overlap_sec, bf_idx - 1)
            self.mapping_corr.append(
                [overlap_sec * self.bfe, (bf_idx - 1) * self.bfe, t])
            self.stats["t_map_select"] += time.time() - t0
        use_global = bf_idx != 0 and self.fixed_section_ids is not None
        sec = self._sec(bf_idx)
        mcfg = MappingConfig(
            num_iters=mp["num_iters"],
            lrs=tuple(sorted((k, float(v)) for k, v in mp["lrs"].items()
                             if k not in ("cam_unnorm_rots", "cam_trans"))),
            loss_cfg=self._loss_cfg(False), use_global=use_global,
            baseframe_every=self.bfe,
            log_global_loss=bool(cfg["use_wandb"]))
        start = bf_idx * self.bfe
        if not self.map_binned:
            new_params = self._map_generic(t, frame, sec, mcfg, use_global)
        else:
            mbk = self.map_backend_kwargs
            W = min(self.bfe, int(cfg["tpu"].get("map_cache_slots", 64)))
            t0 = time.time()
            slots, slot_ids, count = self.map_store.update(
                sec.params, sec.active_mask(), sec.n_active, idx_in,
                self.traj.quats[t].clone(), self.traj.trans[t].clone(),
                self.cam, mbk["span_cap"], mbk["max_pairs_per_tile"], W)
            self.stats["t_map_store"] += time.time() - t0
            gc = (self._global_cache(sec, sec.active_mask(), start,
                                     mbk["max_pairs_per_tile"],
                                     mbk["span_cap"])
                  if use_global else None)
            kf = KeyframeBuffer(colors=self.ring_colors,
                                depths=self.ring_depths, count=count,
                                frame_ids=[start + r for r in range(self.bfe)])
            draws = (self.map_draws(t, mcfg.num_iters, count)
                     if self.map_draws is not None else None)
            t0 = time.time()
            new_params, _ = map_frame_binned(sec.params, kf, slots, slot_ids,
                                             self.cam, mcfg, draws=draws,
                                             generator=self.map_generator,
                                             gc=gc)
            self._page_cold_finish(
                hot={bf_idx} | set(self.fixed_section_ids or ()))
            self._sync()
            self.stats["mapping_loop_time_sum"] += time.time() - t0
            self.stats["mapping_loop_iters"] += mcfg.num_iters
        self.sections[bf_idx] = sec.replace(params=new_params)
        dt = time.time() - t_start
        self.stats["mapping_frame_time_sum"] += dt
        self.stats["mapping_frame_count"] += 1
        self.stats["mapping_iter_time_sum"] += dt
        self.stats["mapping_iter_count"] += max(mp["num_iters"], 1)

    def _map_generic(self, t: int, frame: Frame, sec, mcfg: MappingConfig,
                     use_global: bool):
        """The generic mapping loop over the frame alone at a section's
        first frame, else over the section's ring up to the frame; with the
        frozen concat in front of the section for the global term."""
        idx_in = t % self.bfe
        if idx_in == 0:
            fids = [t]
            colors, depths, count = frame.color[None], frame.depth[None], 1
        else:
            fids = [t - idx_in + r for r in range(self.bfe)]
            colors, depths = self.ring_colors, self.ring_depths
            count = idx_in + 1
        ids = torch.clamp(torch.as_tensor(fids, device=self.device),
                          max=self.num_frames - 1)
        kf = KeyframeBuffer(colors=colors, depths=depths, count=count,
                            quats=self.traj.quats[ids].clone(),
                            trans=self.traj.trans[ids].clone(), frame_ids=fids)
        fixed_params = fixed_active = None
        if use_global:
            fixed_params, fixed_active = self._fixed_concat()
        draws = (self.map_draws(t, mcfg.num_iters, count)
                 if self.map_draws is not None else None)
        t0 = time.time()
        new_params, _ = map_frame(sec.params, sec.active_mask(), kf, self.cam,
                                  mcfg, draws=draws,
                                  generator=self.map_generator,
                                  fixed_params=fixed_params,
                                  fixed_active=fixed_active)
        self._page_cold_finish(hot={t // self.bfe}
                               | set(self.fixed_section_ids or ()))
        self._sync()
        self.stats["mapping_loop_time_sum"] += time.time() - t0
        self.stats["mapping_loop_iters"] += mcfg.num_iters
        return new_params

    # ------------------------------------------------------------------
    def process_frame_zero(self):
        """Frame 0: no tracking; register base frame 0 and map the freshly
        initialized section."""
        before = {k: self.stats[k] for k in TIMER_KEYS}
        t0 = time.time()
        self.baseframes.append(0, self._frame0.depth[0], self.traj.quats[0],
                               self.traj.trans[0])
        self.section_ids[0] = 0
        if self.config["mapping"]["num_iters"] > 0:
            self._map(0, self._frame0)
        self._sync()
        self.frame_times[0] = {
            "track": 0.0, "spawn": 0.0, "densify": 0.0,
            "map": time.time() - t0,
            "timers": {k: self.stats[k] - before[k] for k in TIMER_KEYS
                       if self.stats[k] != before[k]}}
        self.frames_done = max(self.frames_done, 1)

    def process_frame(self, t: int):
        if t == 0:
            return self.process_frame_zero()
        cfg = self.config
        before = {k: self.stats[k] for k in TIMER_KEYS}
        t0 = time.time()
        color_np, depth_np, _, gt_pose = self.dataset[t]
        self.stats["t_dataset"] += time.time() - t0
        self._remember_depth(t, np.asarray(depth_np)[..., 0].astype(np.float32))
        t0 = time.time()
        frame = self._stage(color_np, depth_np)
        self.stats["t_stage"] += time.time() - t0
        gt_w2c = np.linalg.inv(np.asarray(gt_pose, np.float64))
        self.gt_w2c.append(gt_w2c)
        bf_idx = t // self.bfe
        idx_in = t % self.bfe
        boundary = idx_in == 0
        times = {"track": 0.0, "spawn": 0.0, "densify": 0.0, "map": 0.0}

        t0 = time.time()
        if not cfg["tracking"]["use_gt_poses"]:
            self.section_ids[t] = self._track(t, frame)
        else:
            quat, trans = geo.w2c_to_pose(
                torch.as_tensor(gt_w2c, dtype=torch.float32, device=self.device))
            self._traj_write(t, quat, trans)
            self.section_ids[t] = min(bf_idx, len(self.sections) - 1)
        self._sync()
        times["track"] = time.time() - t0

        if boundary:
            t0 = time.time()
            self._new_base_section(t, frame, color_np)
            self._sync()
            times["spawn"] = time.time() - t0
            self.stats["t_spawn"] += times["spawn"]
        self._ring_write(idx_in, frame)

        if (t + 1) % cfg["map_every"] == 0:
            if cfg["mapping"]["add_new_gaussians"] and not boundary:
                t0 = time.time()
                edge_np = self._edge_mask_for(color_np, self.cam.width,
                                              self.cam.height)
                self._densify(t, frame, edge_np, color_np, depth_np)
                self._sync()
                times["densify"] = time.time() - t0
                self.stats["t_densify"] += times["densify"]
            if cfg["mapping"]["num_iters"] > 0:
                t0 = time.time()
                self._map(t, frame)
                self._sync()
                times["map"] = time.time() - t0

        # base-frame bookkeeping: replica registers boundary frames, the
        # others every overlap_every-th keyframe
        if ((t + 1) % cfg["keyframe_every"] == 0 or t == self.num_frames - 2) \
                and np.isfinite(gt_w2c).all():
            is_base = (boundary if self.dataset_name == "replica"
                       else t % cfg["overlap_every"] == 0)
            if is_base:
                self.baseframes.append(t, frame.depth[0], self.traj.quats[t],
                                       self.traj.trans[t])
        self._page_cold_sections({bf_idx} | set(self.fixed_section_ids or ()))
        times["timers"] = {k: self.stats[k] - before[k] for k in TIMER_KEYS
                           if self.stats[k] != before[k]}
        self.frame_times[t] = times
        self.frames_done = max(self.frames_done, t + 1)

    def run(self, num_frames: int | None = None,
            on_frame: Callable[[int], None] | None = None):
        """Frames 0 .. min(num_frames, the sequence) - 1; `on_frame(t)`
        after each."""
        n = min(num_frames or self.num_frames, self.num_frames)
        for t in range(n):
            self.process_frame(t)
            if on_frame is not None:
                on_frame(t)
        self._page_cold_finish()
        return self

    def export_params_ls(self) -> list[dict]:
        """One reference-format params dict per section, each with the
        trajectory of the frames processed (params_ls.npy). A section in
        host memory is exported from its host copy once its page-out has
        landed; none is paged back in."""
        self._page_cold_finish()
        n = self.frames_done or self.num_frames
        traj = G.CameraTrajectory(quats=self.traj.quats[:n],
                                  trans=self.traj.trans[:n])
        return [G.section_to_numpy_params(
            self.host_section(i) if i in self._paged else sec, traj)
            for i, sec in enumerate(self.sections)]

    def close(self):
        """Stop the frame prefetchers' threads."""
        self.dataset.close()
        if self.densify_dataset is not None:
            self.densify_dataset.close()

    # ------------------------------------------------------------------
    # Section paging: sections outside the hot set move to pinned host
    # memory. A page-out starts a non-blocking device -> host copy on the
    # side stream (after the compute stream's work so far) and records an
    # event; the section stays on the device until `_page_cold_finish`
    # swaps in the host copy. Its device tensors are marked as used by the
    # side stream, so the allocator cannot hand their memory out before
    # the copy ends. A host copy may be read only after its event: a page-in
    # queues the host -> device copy on the same side stream (behind the
    # page-out) and makes the compute stream wait for it. On a CPU engine
    # nothing moves; the bookkeeping runs all the same.
    def _sec(self, i: int) -> G.Section:
        """Section i on the device, paging it back in if it is on the host."""
        if i in self._paged:
            t0 = time.time()
            self._page_in(i)
            self.stats["section_page_ins"] += 1
            self.stats["t_page_in"] += time.time() - t0
        return self.sections[i]

    def _page_in(self, i: int):
        event = self._paged.pop(i)
        if self._page_stream is None:
            return
        side = self._page_stream
        with torch.cuda.stream(side):
            if event is not None:
                side.wait_event(event)
            sec = G.map_section(self.sections[i], lambda x: x.to(
                self.device, non_blocking=True))
        cur = torch.cuda.current_stream(self.device)
        cur.wait_stream(side)
        for x in G.section_tensors(sec):
            x.record_stream(cur)
        self.sections[i] = sec

    def _prefetch_sections(self, ids):
        """Start the page-in of sections that a boundary selected, as soon
        as their ids are known; a page-out still in flight is cancelled."""
        for i in ids:
            self._page_pending.pop(i, None)
            if i in self._paged:
                self._page_in(i)
                self.stats["section_page_ins"] += 1
                self.stats["section_prefetched_ins"] += 1

    def _page_cold_sections(self, hot):
        """Start the page-out of every device section outside `hot`."""
        if not self.section_paging:
            return
        t0 = time.time()
        cold = [i for i in range(len(self.sections))
                if i not in hot and i not in self._paged
                and i not in self._page_pending]
        for i in cold:
            sec = self.sections[i]
            if self._page_stream is None:
                self._page_pending[i] = (sec, None)
                continue
            side = self._page_stream
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                host = G.map_section(sec, lambda x: torch.empty(
                    x.shape, dtype=x.dtype, pin_memory=True).copy_(
                        x, non_blocking=True))
                event = torch.cuda.Event()
                event.record(side)
            for x in G.section_tensors(sec):
                x.record_stream(side)
            self._page_pending[i] = (host, event)
        if cold:
            self.stats["t_page"] += time.time() - t0

    def _page_cold_finish(self, hot=()):
        """Swap the host copies in for the pending page-outs, except for
        sections that became hot again (they stay on the device)."""
        if not self._page_pending:
            return
        t0 = time.time()
        for i, (host, event) in self._page_pending.items():
            if i in hot or i in self._paged:
                continue
            self.sections[i] = host
            self._paged[i] = event
            self.stats["section_page_outs"] += 1
        self._page_pending = {}
        self.stats["t_page_fin"] += time.time() - t0

    def paged_sections(self) -> list[int]:
        """The sections held in host memory."""
        return sorted(self._paged)

    def host_section(self, i: int) -> G.Section:
        """Paged-out section i as it lies in host memory, once its copy has
        landed (waits on the page-out's event)."""
        event = self._paged[i]
        if event is not None:
            event.synchronize()
        return self.sections[i]

    def _resident(self, i: int) -> G.Section:
        """Section i on the device without changing the paging state: a
        paged-out section is copied up for the caller alone."""
        if i not in self._paged:
            return self.sections[i]
        return G.map_section(self.host_section(i),
                             lambda x: x.to(self.device))

    # ------------------------------------------------------------------
    def final_stats(self) -> dict:
        s = self.stats
        return {
            "avg_tracking_iter_ms": 1000 * s["tracking_loop_time_sum"]
            / max(s["tracking_loop_iters"], 1),
            "avg_tracking_iter_ms_incl_overhead":
            1000 * s["tracking_iter_time_sum"]
            / max(s["tracking_iter_count"], 1),
            "avg_tracking_frame_s": s["tracking_frame_time_sum"]
            / max(s["tracking_frame_count"], 1),
            "avg_mapping_iter_ms": 1000 * s["mapping_loop_time_sum"]
            / max(s["mapping_loop_iters"], 1),
            "avg_mapping_iter_ms_incl_overhead":
            1000 * s["mapping_iter_time_sum"]
            / max(s["mapping_iter_count"], 1),
            "avg_mapping_frame_s": s["mapping_frame_time_sum"]
            / max(s["mapping_frame_count"], 1),
            "num_gaussians": sum(int(sec.n_active) for sec in self.sections),
            "num_sections": len(self.sections),
            "tile_truncation_frac_max": s["tile_truncation_frac_max"],
            "trunc_probe_diff_max": s["trunc_probe_diff_max"],
            "mpt_boost": self._mpt_boost,
            "section_page_ins": s["section_page_ins"],
            "section_prefetched_ins": s["section_prefetched_ins"],
            "section_page_outs": s["section_page_outs"],
            **{k: s[k] for k in TIMER_KEYS}, "t_densify": s["t_densify"],
        }

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate_frame(self, t: int) -> tuple[float, float]:
        """(PSNR dB, depth L1 m) of the render at the committed pose from
        the section that holds frame t, as the JAX package's eval_sequence
        computes them."""
        color_np, depth_np, _, _ = self.dataset[t]
        sec = self._resident(t // self.bfe)
        bk = eval_pair_budget(sec.n_active, self.cam.height, self.cam.width,
                              self.config["tpu"])
        r = render_slam(sec.params, sec.active_mask(), self.traj.quats[t],
                        self.traj.trans[t], self.cam, bk)
        m = frame_metrics(r, color_np, depth_np, with_ssim=False)
        return m["psnr"], m["l1"]

    def ate(self, num_frames: int) -> float:
        """Mean translational error (Horn-aligned) over frames processed."""
        est = [self.first_frame_w2c]
        for t in range(1, num_frames):
            w2c = geo.pose_to_w2c(geo.normalize(self.traj.quats[t]),
                                  self.traj.trans[t])
            est.append(w2c.detach().cpu().numpy().astype(np.float64))
        return evaluate_ate([np.linalg.inv(x) for x in self.gt_w2c[:num_frames]],
                            [np.linalg.inv(x) for x in est])


def rgbd_slam(config: dict, device="cuda") -> VTGaussianSLAM:
    """Run online SLAM over a config's whole sequence (the reference's
    entry point); the engine holds the map and the trajectory."""
    engine = VTGaussianSLAM(config, device=device)
    engine.run()
    return engine
