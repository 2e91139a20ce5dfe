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

With `tpu.mesh_devices` = N > 1 the engine runs as one
of N ranks of a `torch.distributed` group (parallel/engine.py): each rank
holds the whole state and renders its range of tile rows in the default
loops; everything else runs replicated, and rank 0 alone writes files.

As in the JAX engine, `gaussian_distribution="anisotropic"` changes the
route but not the Gaussians: sections are seeded with (N, 1) log-scales
either way. The pair budget follows `auto_pair_budget` times a boost that
the measured truncation harm (map_cache.trunc_probe) drives.

ScanNet++ configs probe each frame's loss at the propagated pose (one
render) and, above `init_err_ratio` x the running medians of the tracked
frames' final losses, double the iterations and start from the RGB-D
visual odometer's pose relative to the previous frame (core/odometry.py);
`tracking.multiavg` averages the two last relative motions from frame 4 on.
With `use_wandb` the loops keep their loss histories on the device, read
once per frame into `RunLogger` records (utils/observability.py), and every
`report_global_progress_every` frames a render at the committed pose is
scored and logged (`t_progress`). `run` saves a checkpoint every
`checkpoint_interval` frames with `save_checkpoints` and resumes from one
with `load_checkpoint` (utils/checkpoint.py).

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

import contextlib
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
from ..utils.common import resolve_device, save_params_ckpt
from ..utils.observability import (RunLogger, Trace, frame_quality,
                                   report_loss, report_progress,
                                   save_progress_panel,
                                   save_tracking_loss_viz, span_seconds)
from .config import (MAP_CACHE_SLOTS, TRUNC_PROBE_EVERY, auto_pair_budget,
                     prepare_config, separate_densification_res)
from .densify import (base_frame_pointcloud, densify_from_pixels,
                      densify_nonpresence, first_frame_pointcloud)
from .losses import Frame, LossConfig, render_slam
from .map_cache import MapCacheStore, build_global_cache, trunc_probe
from .mapping import (FUSED, SLOTS, KeyframeBuffer, MappingConfig, map_frame,
                      map_frame_binned)
from .p2p import P2PTarget, make_p2p_target
from .selection import (find_earliest_keyframe, overlap_percents,
                        select_earliest_topk_base, select_topk_overlap,
                        select_visbased)
from .track_cache import build_track_cache
from .tracking import (GRAPHED, TrackingConfig, init_track_state,
                       probe_loss, track_frame, track_frame_cached)

# the spans that `frame_times[t]["timers"]` sums per frame, under the
# names of the `stats` keys that sum them over the run: the boundary work,
# the paging, and the frame's load and staging
TIMER_SPANS = {"track.select": "t_select", "select.pool": "t_sel_pool",
               "select.walk": "t_sel_walk", "track.prefetch": "t_prefetch",
               "track.prep": "t_track_prep", "track.cache": "t_track_cache",
               "spawn": "t_spawn", "map.select": "t_map_select",
               "map.global.concat": "t_global_concat",
               "map.global": "t_global_cache", "map.store": "t_map_store",
               "page.out": "t_page", "page.in": "t_page_in",
               "page.finish": "t_page_fin", "load.read": "t_dataset",
               "load.stage": "t_stage", "progress": "t_progress"}
# every span and counter that a `stats` key sums
STAT_TOTALS = {**TIMER_SPANS, "densify": "t_densify",
               "checkpoint": "t_checkpoint", "map": "mapping_frame_time_sum",
               "track.loop": "tracking_loop_time_sum",
               "map.loop": "mapping_loop_time_sum",
               "track.iters": "tracking_loop_iters",
               "map.iters": "mapping_loop_iters",
               "page.ins": "section_page_ins",
               "page.outs": "section_page_outs"}
# `frame_times[t]`'s phases: the seconds of the spans of these names
PHASES = ("track", "spawn", "densify", "map")


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
        self._setup_mesh(int(tpu.get("mesh_devices", 1) or 1))

        self.dataset_name = gradslam_config(data_cfg)["dataset_name"]
        if self.dataset_name == "synthetic" and cfg.get("selection_style"):
            # a synthetic proxy runs its scene family's selection
            self.dataset_name = cfg["selection_style"]

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
        self.map_store = MapCacheStore(select=self._bin_select,
                                       tile_pad=self.tile_pad)
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
        # each new section's initial count, then each densify's additions
        self.num_gs_per_frame_ls: list[int] = []
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
        # ScanNet++: the initial-error probe's history and the odometer
        # that re-initializes a frame whose probe loss is far above it
        self.odometer = None
        self.frame_color_loss: list[float] = []
        self.frame_depth_loss: list[float] = []
        self.rescue_log: list[dict] = []
        if self.dataset_name == "scannetpp":
            from .odometry import VisualOdometer
            self.odometer = VisualOdometer(
                self.intrinsics, cfg.get("odometer_method", "point_to_plane"),
                device=self.device)
        # the use_wandb event stream: wandb when it imports, else
        # <run>/events.jsonl; the loops keep loss histories only for it
        wb = cfg.get("wandb", {})
        self.logger = RunLogger(
            enabled=bool(cfg.get("use_wandb")) and self.rank == 0,
            project=wb.get("project", ""),
            group=wb.get("group", ""), name=wb.get("name", ""),
            entity=wb.get("entity", ""), config=cfg,
            out_dir=self.run_dir())
        self._keep_hist = bool(cfg.get("use_wandb")) or bool(
            cfg["tracking"].get("visualize_tracking_loss", False))
        self._track_hist: list[tuple] = []   # this frame's (im, depth) streams
        self._wandb_track_step = self._wandb_map_step = 0
        self._panels = None     # matplotlib importable (checked once)
        self.checkpoint_log: list[dict] = []
        self.stats = {
            "tracking_frame_time_sum": 0.0, "tracking_frame_count": 0,
            "tracking_loop_time_sum": 0.0, "tracking_loop_iters": 0,
            "mapping_frame_time_sum": 0.0, "mapping_frame_count": 0,
            "mapping_loop_time_sum": 0.0, "mapping_loop_iters": 0,
            "tile_truncation_frac_max": 0.0, "trunc_probe_diff_max": 0.0,
            "section_page_ins": 0, "section_prefetched_ins": 0,
            "section_page_outs": 0, "t_densify": 0.0,
            "t_checkpoint": 0.0, **{k: 0.0 for k in TIMER_SPANS.values()}}
        # the frames' spans and counters (frame_times[t]["spans"] /
        # ["counts"]); they sum into `stats`
        self.trace = Trace(self.stats, STAT_TOTALS)
        self._init_first_frame(color0, depth0)

    def _setup_mesh(self, md: int):
        """tpu.mesh_devices > 1: the cached tracking and binned mapping
        loops run tile-sharded over the process group's ranks
        (parallel/engine.py), which must number exactly md; a config that
        routes to the generic loops (which have no sharded twin) raises
        unless tpu.allow_unsharded_fallback is set. Only rank 0 writes
        files."""
        self.group = None
        self.rank = 0
        self.tile_pad = 0
        self._track_cached_fn = track_frame_cached
        self._map_binned_fn = map_frame_binned
        if md <= 1:
            return
        cfg, tpu = self.config, self.config["tpu"]
        reasons = []
        if cfg["gaussian_distribution"] != "isotropic":
            reasons.append("gaussian_distribution != 'isotropic'")
        if not tpu.get("track_cache", True):
            reasons.append("tpu.track_cache=False")
        mlrs = cfg["mapping"]["lrs"]
        if (float(mlrs.get("means3D", 0.0)) != 0.0
                or float(mlrs.get("unnorm_rotations", 0.0)) != 0.0):
            reasons.append("nonzero means3D/unnorm_rotations mapping lrs")
        if not tpu.get("map_binned", self.device.type != "cpu"):
            reasons.append("tpu.map_binned=False")
        if reasons and not tpu.get("allow_unsharded_fallback", False):
            raise ValueError(
                "tpu.mesh_devices > 1 but this config routes to the generic "
                "(unsharded) tracking/mapping paths: " + "; ".join(reasons)
                + ". Set tpu.allow_unsharded_fallback=True to accept "
                "unsharded execution of those paths on every rank.")
        from ..parallel.engine import (make_map_frame_binned_sharded,
                                       make_mesh,
                                       make_track_frame_cached_sharded,
                                       tile_pad_for)
        self.group = make_mesh(md)
        self.rank = self.group.rank
        self.tile_pad = tile_pad_for(self.group.world)
        self._track_cached_fn = make_track_frame_cached_sharded(self.group)
        self._map_binned_fn = make_map_frame_binned_sharded(self.group)

    # ------------------------------------------------------------------
    def run_dir(self) -> str:
        return os.path.join(self.config.get("workdir", "."),
                            self.config.get("run_name", "run"))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.trace.synced()

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
        return LossConfig(
            tracking=tracking, use_sil_for_loss=tr["use_sil_for_loss"],
            ignore_outlier_depth_loss=tr["ignore_outlier_depth_loss"],
            adaptive_sil=(tracking and self.dataset_name == "replica"
                          and tr["use_sil_for_loss"]),
            im_weight=float(tr["loss_weights"]["im"]),
            depth_weight=float(tr["loss_weights"]["depth"]),
            backend_kwargs=tuple(sorted(self.backend_kwargs.items())))

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
        self.num_gs_per_frame_ls.append(n)

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
        at t == 1); with tracking.multiavg, from t > 3 on, the average of
        the two last relative motions."""
        q, tr = self.traj.quats, self.traj.trans
        if t <= 1:
            return q[t - 1].clone(), tr[t - 1].clone()

        def w2c_of(i):
            return geo.pose_to_w2c(geo.normalize(q[i]), tr[i])

        if self.config["tracking"].get("multiavg", False) and t > 3:
            w2c = geo.constant_velocity_init_multiavg(
                w2c_of(t - 1), w2c_of(t - 2), w2c_of(t - 3))
        else:
            w2c = geo.constant_velocity_init(w2c_of(t - 1), w2c_of(t - 2))
        return geo.rotmat_to_quat(w2c[:3, :3]), w2c[:3, 3]

    def _pose_from_rel(self, t: int, rel_c2w: np.ndarray):
        """The odometer's init: w2c_t = inv(c2w_{t-1} @ rel)."""
        rel = torch.as_tensor(np.asarray(rel_c2w, np.float32),
                              device=self.device)
        c2w = geo.invert_se3(self._traj_w2c(t - 1)) @ rel
        w2c = geo.invert_se3(c2w)
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
            with self.trace.span("select.pool"):
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
                self.tracking_corr.append(
                    [top_time, (bf_idx - 1) * self.bfe, t])
            with self.trace.span("select.walk"):
                earliest = find_earliest_keyframe(
                    self.tracking_corr, lambda i: float(pct[i]), self.bfe,
                    tr["keyframe_thresh"])
                self.earliest_corr.append([earliest, None, t])
            return [earliest // self.bfe], earliest
        if self.dataset_name == "scannetpp":
            return [bf_idx - 1], (bf_idx - 1) * self.bfe

        # tum / scannet (and plain synthetic): all-pixel visibility scoring
        # over the pool less the newest base frames, earliest top-k sections
        ignore = int(self.bfe / cfg["overlap_every"])
        pool = max(len(bfs) - (ignore - 1), 1)
        with self.trace.span("select.pool"):
            pct = overlap_percents(
                frame.depth[0], cand_w2c, self.K, bfs.w2cs(rung),
                bfs.depths[:rung], pixels=0, edge=tr["edge"], use_vis=True,
                kf_depth_thresh=tr["kf_depth_thresh"],
                depth_stride=bfs.stride).cpu().numpy()
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
        """Tracking for one frame; commits the best pose (the `pose_ready`
        mark) and returns the section it tracked against."""
        cfg = self.config
        tr = cfg["tracking"]
        trace = self.trace
        with trace.span("track.prep") as prep:
            self._update_pair_budget()
            bf_idx = t // self.bfe
            boundary = t % self.bfe == 0
            q0, tr0 = self._propagate_pose(t)
            self._traj_write(t, q0, tr0)

            far_mask = None
            if self.dataset_name != "replica":
                # far-depth filter: factor x mean of the 30 largest frame
                # means (the statistics grow on ScanNet++ too, where no
                # mask applies)
                d = frame.depth
                dm = float((d * (d > 0)).sum()
                           / torch.clamp((d > 0).sum(), min=1))
                self.depth_means = sorted(self.depth_means + [dm])
                if self.dataset_name != "scannetpp":
                    far_id = min(30, len(self.depth_means))
                    far_thres = cfg["far_depth_factor"] * float(
                        np.mean(self.depth_means[-far_id:]))
                    far_mask = frame.depth[0] < far_thres

            num_iters = tr["num_iters"]
            if (self.dataset_name != "scannetpp" and bf_idx == 0
                    and tr.get("base1_num_iters")):
                num_iters = tr["base1_num_iters"]
            sil_thres = tr["sil_thres"]
            if boundary and tr.get("sil_thres_base") is not None:
                sil_thres = tr["sil_thres_base"]
            if self.odometer is not None:
                num_iters, q0, tr0 = self._rescue(t, frame, q0, tr0,
                                                  sil_thres, num_iters)

            at_boundary = boundary and bf_idx >= 1
            if at_boundary:
                with trace.span("track.select"):
                    cand_secs, overlap_frame = self._select_boundary_sections(
                        t, frame, self._traj_w2c(t))
                with trace.span("track.prefetch"):
                    self._prefetch_sections(cand_secs)
            else:
                cand_secs = [min(bf_idx, len(self.sections) - 1)]
                overlap_frame = None

        def tcfg_of(n, metric):
            return TrackingConfig(
                num_iters=n, lr_quat=tr["lrs"]["cam_unnorm_rots"],
                lr_trans=tr["lrs"]["cam_trans"], metric=metric,
                p2p_method=tr["p2p_method"], loss_cfg=self._loss_cfg(True),
                keep_hist=self._keep_hist)

        t_prep = 0      # ns of boundary prep inside the tracking window
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
            with trace.span("track.prep") as bprep:
                chosen_base = sec_id * self.bfe
                aux = self._boundary_vis_mask(t, frame, state, chosen_base)
                if far_mask is not None:
                    aux = aux & far_mask
                p2p_t = self._overlap_p2p_target(chosen_base)
            t_prep = bprep.t1 - bprep.t0
            state.min_metric = torch.full_like(state.min_metric, 1e20)
            n2 = max(num_iters - phase1.num_iters, 0)
            if n2 > 0:
                state = self._run_track(self._sec(sec_id), state, frame, aux,
                                        p2p_t, tcfg_of(n2, "p2p"))
        else:
            metric, p2p_t = "loss", None
            if at_boundary and self.dataset_name == "replica":
                with trace.span("track.prep") as bprep:
                    metric = "p2p"
                    p2p_t = self._overlap_p2p_target(overlap_frame)
                t_prep = bprep.t1 - bprep.t0
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
        self._traj_write(t, state.best_quat, state.best_trans)
        ready = trace.mark("pose_ready")
        # the tracking window: from the host prep's end to the committed
        # pose, less the boundary's prep inside it
        self.stats["tracking_frame_time_sum"] += (
            ready - prep.t1 - t_prep) / 1e9
        self.stats["tracking_frame_count"] += 1
        if self.dataset_name == "scannetpp":
            # the final iteration's losses, the probe's running median
            im_l, d_l = torch.stack([state.im_loss, state.depth_loss]).tolist()
            self.frame_color_loss.append(im_l)
            self.frame_depth_loss.append(d_l)
        self._log_track_losses()
        return sec_id

    def _rescue(self, t: int, frame: Frame, q0, tr0, sil_thres: float,
                num_iters: int):
        """ScanNet++: the loss at the propagated pose (one render, K4 on
        the card) against init_err_ratio x the running medians of the
        tracked frames' final losses; above either, the frame gets twice
        the iterations and, with help_camera_initialization, the visual
        odometer's pose relative to frame t-1 as its init. Returns
        (num_iters, quat, trans)."""
        cfg = self.config
        bf_idx = t // self.bfe
        sec = self._sec(bf_idx - 1 if t % self.bfe == 0 else bf_idx)
        im_l, d_l = probe_loss(sec.params, sec.active_mask(), q0, tr0, frame,
                               self.cam, self._loss_cfg(True), sil_thres)
        im_l, d_l = torch.stack([im_l, d_l]).tolist()
        ratio = cfg.get("init_err_ratio", 50)
        fired = bool(self.frame_color_loss) and (
            im_l > ratio * float(np.median(self.frame_color_loss))
            or d_l > ratio * float(np.median(self.frame_depth_loss)))
        rel = None
        if fired:
            num_iters = 2 * num_iters
            if (cfg.get("help_camera_initialization")
                    and cfg.get("odometry_type") != "odometer"):
                last_color, last_depth, _, _ = self.dataset[t - 1]
                self.odometer.update_last_rgbd(last_color, last_depth)
                rel = self.odometer.estimate_rel_pose(self._color_np,
                                                      frame.depth[0])
                q0, tr0 = self._pose_from_rel(t, rel)
                self._traj_write(t, q0, tr0)
        self.rescue_log.append(dict(t=t, probe_im=im_l, probe_depth=d_l,
                                    fired=fired, num_iters=num_iters,
                                    odometer_rel=rel))
        return num_iters, q0, tr0

    def _log_track_losses(self):
        """The frame's per-iteration tracking losses as use_wandb records,
        read from the device once."""
        hists, self._track_hist = self._track_hist, []
        if not self.config["use_wandb"] or not hists:
            return
        w = self.config["tracking"]["loss_weights"]
        im = torch.cat([h[0] for h in hists])
        dl = torch.cat([h[1] for h in hists])
        for il, d in torch.stack([im, dl], 1).tolist():
            self._wandb_track_step = report_loss(
                {"loss": w["im"] * il + w["depth"] * d, "im": il,
                 "depth": d}, self.logger, self._wandb_track_step,
                tracking=True)

    def _run_track(self, sec, state, frame, aux_mask, p2p_t, tcfg):
        """The frozen-binning tracking loop over one binning at the initial
        pose, then the truncation probe at the best pose on its cadence;
        the generic loop when the cache route is off."""
        trace = self.trace
        if not self.track_cached:
            with trace.span("track.loop"):
                state, im_h, d_h = track_frame(sec.params, sec.active_mask(),
                                               state, frame, aux_mask,
                                               self.cam, tcfg, p2p_t)
                self._sync()
            trace.count("track.iters", tcfg.num_iters)
            self._track_hist_add(sec, state, frame, aux_mask, tcfg, im_h,
                                 d_h)
            return state
        bk = self.backend_kwargs
        mpt = bk["max_pairs_per_tile"]
        with trace.span("track.cache"):
            cache = build_track_cache(
                sec.params, sec.active_mask(), state.quat, state.trans,
                self.cam, span_cap=bk["span_cap"], max_pairs_per_tile=mpt,
                chunk=bk["chunk"], tile_pad=self.tile_pad,
                select=self._bin_select)
        replayed = GRAPHED.replays
        with trace.span("track.loop"):
            state, im_h, d_h = self._track_cached_fn(
                cache, state, frame, aux_mask, self.cam, tcfg, p2p_t)
            self._sync()
        trace.count("track.iters", tcfg.num_iters)
        trace.count("track.graph_iters", GRAPHED.replays - replayed)
        n_tiles = (-(-self.cam.height // 16)) * (-(-self.cam.width // 16))
        self.stats["tile_truncation_frac_max"] = max(
            self.stats["tile_truncation_frac_max"],
            float((cache.counts[:n_tiles] >= mpt).double().mean()))
        if self.config["tpu"].get("auto_pair_budget", True):
            # the measured harm at the best pose, read on the next frame
            # (no wait here): every frame until two readings exist, then
            # every TRUNC_PROBE_EVERY frames
            if (len(self._harm_hist) < 2
                    or self._frames_tracked % TRUNC_PROBE_EVERY == 0):
                self._pending_harm = trunc_probe(
                    sec.params, sec.active_mask(), state.best_quat,
                    state.best_trans, self.cam, span_cap=bk["span_cap"],
                    mpt=mpt, select=self._bin_select)
                self._pending_harm_mpt = mpt
        self._frames_tracked += 1
        self._track_hist_add(sec, state, frame, aux_mask, tcfg, im_h, d_h)
        return state

    def _track_hist_add(self, sec, state, frame, aux_mask, tcfg, im_h, d_h):
        """Keep a tracking call's loss streams for the frame's records and,
        with tracking.visualize_tracking_loss, draw its figure."""
        if not tcfg.keep_hist:
            return
        self._track_hist.append((im_h, d_h))
        if (not self.config["tracking"].get("visualize_tracking_loss", False)
                or self.rank != 0):
            return
        t = self._cur_frame
        with torch.no_grad():
            r = render_slam(sec.params, sec.active_mask(), state.best_quat,
                            state.best_trans, self.cam, self.backend_kwargs)
        save_tracking_loss_viz(
            os.path.join(self.run_dir(), "tracking_loss_viz",
                         f"frame{t:04d}.png"),
            r, frame, float(state.sil_thres), aux_mask=aux_mask,
            im_hist=im_h, depth_hist=d_h,
            title=f"Frame{t:04d} tracking ({tcfg.num_iters} iterations)")

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
        trace = self.trace
        bf_idx = t // self.bfe
        sec = self._sec(bf_idx)
        quat, trans = self.traj.quats[t], self.traj.trans[t]
        with trace.span("densify.render"):
            npres = densify_nonpresence(
                sec.params, sec.active_mask(), quat, trans, frame, self.cam,
                self.config["mapping"]["sil_thres"],
                tuple(sorted(self.backend_kwargs.items())))
            np_np = npres.cpu().numpy()
        with trace.span("densify.candidates"):
            d0 = depth_np[..., 0]
            idx_b = np.flatnonzero(np_np & (d0 > 0))
            parts = [self._pixel_candidates(idx_b, d0, color_np, self.cam,
                                            quat, trans)]
            dcam = self.densify_cam
            np_mask = resize_mask_nearest(np_np.astype(np.uint8), dcam.width,
                                          dcam.height).astype(bool)
            e_mask = resize_mask_nearest(edge_mask_np.astype(np.uint8),
                                         dcam.width, dcam.height).astype(bool)
            if self.sep_densify:
                dcolor_np, ddepth_np = self.densify_dataset[t][:2]
            else:
                dcolor_np, ddepth_np = color_np, depth_np
            dd0 = np.asarray(ddepth_np)[..., 0]
            idx_s = np.flatnonzero(np_mask & e_mask & (dd0 > 0))
            parts.append(self._pixel_candidates(
                idx_s, dd0, np.asarray(dcolor_np), dcam, quat, trans))
        n_new = len(idx_b) + len(idx_s)
        need = sec.n_active + n_new
        if need > sec.capacity:
            sec = G.repad_section(sec, G.round_capacity(need, self.quantum))
        for c in parts:
            sec = G.append_gaussians(sec, c.points, c.colors, c.mean3_sq_dist,
                                     c.keep, float(t))
        self.sections[bf_idx] = sec
        self.num_gs_per_frame_ls.append(n_new)
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
        with self.trace.span("map.global.concat"):
            fixed, _ = G.concat_sections(
                [self._sec(i) for i in self.fixed_section_ids],
                quantum=self.quantum)
        return fixed.params, fixed.active_mask()

    def _global_cache(self, sec, active, start: int, mpt: int, span_cap: int):
        """The global binning of [fixed sections; section] at the section's
        base keyframe, rebuilt when its key changes or every
        tpu.global_cache_refresh_every frames; its pair budget is sized from
        the concat's count."""
        with self.trace.span("map.global"):
            refresh_every = int(
                self.config["tpu"].get("global_cache_refresh_every", 4))
            sizes = [int(self._sec(i).n_active)
                     for i in self.fixed_section_ids]
            fixed_cap = G.round_capacity(sum(sizes), self.quantum)
            gkey = (self.fixed_section_ids, sec.capacity, fixed_cap, mpt,
                    self._mpt_boost, start)
            build = (self._gcache is None or self._gcache_key != gkey
                     or self._gcache_age >= refresh_every)
            if build:
                self._gcache = None     # free the old binning first
                fixed_params, fixed_active = self._fixed_concat()
                tiles = (-(-self.cam.width // 16)) * (-(-self.cam.height // 16))
                g_mpt = auto_pair_budget(sec.n_active + sum(sizes), tiles,
                                         span_cap, mpt, boost=self._mpt_boost)
                gc = build_global_cache(
                    fixed_params, fixed_active, sec.params, active,
                    self.traj.quats[start].clone(),
                    self.traj.trans[start].clone(), self.cam,
                    span_cap=span_cap, max_pairs_per_tile=g_mpt,
                    tile_pad=self.tile_pad, select=self._bin_select)
                g_trunc = float((gc.counts[:tiles] >= g_mpt).double().mean())
                self.stats["tile_truncation_frac_max"] = max(
                    self.stats["tile_truncation_frac_max"], g_trunc)
                self._gcache, self._gcache_key, self._gcache_age = gc, gkey, 1
            else:
                self._gcache_age += 1
        return self._gcache

    def _map(self, t: int, frame: Frame):
        """Mapping phase for one frame: over the section's keyframe caches
        on the binned route, else the generic route; with the global term
        once a boundary has fixed the frozen sections."""
        cfg = self.config
        mp = cfg["mapping"]
        self._update_pair_budget()
        trace = self.trace
        bf_idx = t // self.bfe
        idx_in = t % self.bfe
        if idx_in == 0 and bf_idx != 0:
            with trace.span("map.select"):
                overlap_sec = self._select_mapping_overlap(t, frame)
                self.fixed_section_ids = (overlap_sec, bf_idx - 1)
                self.mapping_corr.append(
                    [overlap_sec * self.bfe, (bf_idx - 1) * self.bfe, t])
        use_global = bf_idx != 0 and self.fixed_section_ids is not None
        sec = self._sec(bf_idx)
        mcfg = MappingConfig(
            num_iters=mp["num_iters"],
            lrs=tuple(sorted((k, float(v)) for k, v in mp["lrs"].items()
                             if k not in ("cam_unnorm_rots", "cam_trans"))),
            loss_cfg=self._loss_cfg(False), use_global=use_global,
            baseframe_every=self.bfe,
            log_global_loss=bool(cfg["use_wandb"]),
            keep_hist=bool(cfg["use_wandb"]))
        start = bf_idx * self.bfe
        if not self.map_binned:
            new_params, hist = self._map_generic(t, frame, sec, mcfg,
                                                 use_global)
        else:
            bk = self.backend_kwargs
            W = min(self.bfe, MAP_CACHE_SLOTS)
            with trace.span("map.store"):
                slots, slot_ids, count = self.map_store.update(
                    sec.params, sec.active_mask(), sec.n_active, idx_in,
                    self.traj.quats[t].clone(), self.traj.trans[t].clone(),
                    self.cam, bk["span_cap"], bk["max_pairs_per_tile"], W)
            trace.count("map.binnings_built", self.map_store.n_built)
            gc = (self._global_cache(sec, sec.active_mask(), start,
                                     bk["max_pairs_per_tile"], bk["span_cap"])
                  if use_global else None)
            kf = KeyframeBuffer(colors=self.ring_colors,
                                depths=self.ring_depths, count=count,
                                frame_ids=[start + r for r in range(self.bfe)])
            draws = (self.map_draws(t, mcfg.num_iters, count)
                     if self.map_draws is not None else None)
            fused, slotted = FUSED.iters, SLOTS.iters
            with trace.span("map.loop"):
                new_params, hist = self._map_binned_fn(
                    sec.params, kf, slots, slot_ids, self.cam, mcfg,
                    draws=draws, generator=self.map_generator, gc=gc)
                self._page_cold_finish(
                    hot={bf_idx} | set(self.fixed_section_ids or ()))
                self._sync()
            trace.count("map.iters", mcfg.num_iters)
            trace.count("map.loss_fused", FUSED.iters - fused)
            trace.count("map.slot_kernels", SLOTS.iters - slotted)
        self.sections[bf_idx] = sec.replace(params=new_params)
        if hist is not None:
            # (num_iters, 3) [total, im, depth]: one device read per frame
            for loss, il, dl in hist.tolist():
                self._wandb_map_step = report_loss(
                    {"loss": loss, "im": il, "depth": dl}, self.logger,
                    self._wandb_map_step, mapping=True)
        self.stats["mapping_frame_count"] += 1

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
        fused, slotted = FUSED.iters, SLOTS.iters
        with self.trace.span("map.loop"):
            new_params, hist = map_frame(sec.params, sec.active_mask(), kf,
                                         self.cam, mcfg, draws=draws,
                                         generator=self.map_generator,
                                         fixed_params=fixed_params,
                                         fixed_active=fixed_active)
            self._page_cold_finish(hot={t // self.bfe}
                                   | set(self.fixed_section_ids or ()))
            self._sync()
        self.trace.count("map.iters", mcfg.num_iters)
        self.trace.count("map.loss_fused", FUSED.iters - fused)
        self.trace.count("map.slot_kernels", SLOTS.iters - slotted)
        return new_params, hist

    # ------------------------------------------------------------------
    def process_frame_zero(self):
        """Frame 0: no tracking; register base frame 0 and map the freshly
        initialized section."""
        trace = self.trace
        mapped = self.config["mapping"]["num_iters"] > 0
        with trace.frame() as rec:
            with trace.span("map") if mapped else contextlib.nullcontext():
                self.baseframes.append(0, self._frame0.depth[0],
                                       self.traj.quats[0], self.traj.trans[0])
                self.section_ids[0] = 0
                if mapped:
                    self._map(0, self._frame0)
                self._sync()
        self.frame_times[0] = self._frame_times(rec)
        self.frames_done = max(self.frames_done, 1)

    def process_frame(self, t: int):
        if t == 0:
            return self.process_frame_zero()
        cfg = self.config
        trace = self.trace
        self._cur_frame = t
        with trace.frame() as rec:
            with trace.span("load.read"):
                color_np, depth_np, _, gt_pose = self.dataset[t]
            self._color_np = color_np
            self._remember_depth(
                t, np.asarray(depth_np)[..., 0].astype(np.float32))
            with trace.span("load.stage"):
                frame = self._stage(color_np, depth_np)
            gt_w2c = np.linalg.inv(np.asarray(gt_pose, np.float64))
            self.gt_w2c.append(gt_w2c)
            bf_idx = t // self.bfe
            idx_in = t % self.bfe
            boundary = idx_in == 0

            with trace.span("track"):
                if not cfg["tracking"]["use_gt_poses"]:
                    self.section_ids[t] = self._track(t, frame)
                else:
                    quat, trans = geo.w2c_to_pose(torch.as_tensor(
                        gt_w2c, dtype=torch.float32, device=self.device))
                    self._traj_write(t, quat, trans)
                    self.section_ids[t] = min(bf_idx, len(self.sections) - 1)
                self._sync()

            if boundary:
                with trace.span("spawn"):
                    self._new_base_section(t, frame, color_np)
                    self._sync()
            self._ring_write(idx_in, frame)

            if (t + 1) % cfg["map_every"] == 0:
                if cfg["mapping"]["add_new_gaussians"] and not boundary:
                    with trace.span("densify"):
                        with trace.span("densify.edge"):
                            edge_np = self._edge_mask_for(
                                color_np, self.cam.width, self.cam.height)
                        self._densify(t, frame, edge_np, color_np, depth_np)
                        self._sync()
                if cfg["mapping"]["num_iters"] > 0:
                    with trace.span("map"):
                        self._map(t, frame)
                        self._sync()
            if cfg["use_wandb"] and (
                    (t + 1) % cfg["report_global_progress_every"] == 0):
                with trace.span("progress"):
                    self._report_progress(t, frame)

            # base-frame bookkeeping: replica registers boundary frames, the
            # others every overlap_every-th keyframe
            if ((t + 1) % cfg["keyframe_every"] == 0
                    or t == self.num_frames - 2) and np.isfinite(gt_w2c).all():
                is_base = (boundary if self.dataset_name == "replica"
                           else t % cfg["overlap_every"] == 0)
                if is_base:
                    self.baseframes.append(t, frame.depth[0],
                                           self.traj.quats[t],
                                           self.traj.trans[t])
            self._page_cold_sections({bf_idx}
                                     | set(self.fixed_section_ids or ()))
        self.frame_times[t] = self._frame_times(rec)
        self.frames_done = max(self.frames_done, t + 1)

    @staticmethod
    def _frame_times(rec) -> dict:
        """`frame_times[t]`: the phases' and the timers' seconds, each the
        sum of its spans, with the frame's spans and counters."""
        sums = span_seconds(rec.spans)
        times = {p: sums.get(p, 0.0) for p in PHASES}
        times["timers"] = {k: sums[n] for n, k in TIMER_SPANS.items()
                           if n in sums}
        times["spans"], times["counts"] = rec.spans, rec.counts
        return times

    def _report_progress(self, t: int, frame: Frame):
        """The use_wandb per-frame report: a render at the committed pose
        (K4 on the card), its presence-masked PSNR and depth RMSE at the
        tracking silhouette threshold with the latest pose error, and the
        2x4 panel under plots/ where matplotlib imports (one note per run
        where it does not). A failed render or metric dumps the newest
        section as params<t>.npz, as the JAX engine does."""
        sil = self.config["tracking"]["sil_thres"]
        try:
            sec = self._sec(min(t // self.bfe, len(self.sections) - 1))
            with torch.no_grad():
                r = render_slam(sec.params, sec.active_mask(),
                                self.traj.quats[t], self.traj.trans[t],
                                self.cam, self.backend_kwargs)
            psnr, depth_rmse, _, _ = frame_quality(r, frame, sil)
            report_progress(self.logger, t,
                            self._traj_w2c(t).cpu().numpy(), self.gt_w2c,
                            psnr=psnr, depth_rmse=depth_rmse)
        except Exception:
            i = len(self.sections) - 1
            last = self.host_section(i) if i in self._paged else \
                self.sections[i]
            if self.rank == 0:
                save_params_ckpt(G.section_to_numpy_params(last, self.traj),
                                 self.run_dir(), t)
            print("Failed to evaluate trajectory.")
            return
        if self._panels is None:
            try:
                import matplotlib  # noqa: F401
                self._panels = True
            except ImportError:
                self._panels = False
                print("NOTE: no matplotlib: panels skipped (the progress "
                      "records are logged)")
        if self._panels and self.rank == 0:
            save_progress_panel(
                os.path.join(self.run_dir(), "plots", f"frame_{t:05d}.png"),
                r, frame, sil, title=f"frame {t}: PSNR {psnr:.2f}  "
                                     f"depth RMSE {depth_rmse:.3f}")

    def run(self, num_frames: int | None = None,
            on_frame: Callable[[int], None] | None = None):
        """Frames 0 .. min(num_frames, the sequence) - 1, `on_frame(t)` after
        each; from the checkpoint the config names when `load_checkpoint`
        is set, and with a checkpoint every `checkpoint_interval` frames
        when `save_checkpoints` is; then, with use_wandb, the Final Stats
        record."""
        from ..utils.checkpoint import load_checkpoint
        cfg = self.config
        n = min(num_frames or self.num_frames, self.num_frames)
        start = 0
        if cfg.get("load_checkpoint"):
            t0 = time.time()
            start = load_checkpoint(
                self, time_idx=cfg.get("checkpoint_time_idx") or None)
            self.checkpoint_log.append(dict(t=start - 1, load_s=time.time()
                                            - t0))
            print(f"Resumed from checkpoint at frame {start - 1}")
        for t in range(start, n):
            self.process_frame(t)
            self.maybe_checkpoint(t)
            if on_frame is not None:
                on_frame(t)
        self._page_cold_finish()
        if cfg["use_wandb"]:
            s = self.final_stats()
            self.logger.log({
                "Final Stats/Average Tracking Iteration Time (ms)":
                    s["avg_tracking_iter_ms"],
                "Final Stats/Average Tracking Frame Time (s)":
                    s["avg_tracking_frame_s"],
                "Final Stats/Average Mapping Iteration Time (ms)":
                    s["avg_mapping_iter_ms"],
                "Final Stats/Average Mapping Frame Time (s)":
                    s["avg_mapping_frame_s"],
                "Final Stats/step": 1})
            self.logger.finish()
        return self

    def maybe_checkpoint(self, t: int):
        """After frame t: with save_checkpoints, a checkpoint every
        checkpoint_interval frames (not after frame 0), its seconds in
        frame_times[t]["checkpoint"], apart from the frame's split."""
        cfg = self.config
        if (t == 0 or not cfg.get("save_checkpoints") or self.rank != 0
                or (t + 1) % cfg.get("checkpoint_interval", 100)):
            return
        from ..utils.checkpoint import save_checkpoint
        with self.trace.span("checkpoint") as sp:
            path = save_checkpoint(self, t)
        dt = (sp.t1 - sp.t0) / 1e9
        self.frame_times[t]["checkpoint"] = dt
        # a truncation-probe reading in flight is not saved (a resume
        # re-probes), so the resumed run can part from this one there
        self.checkpoint_log.append(dict(
            t=t, path=path, save_s=dt, bytes=os.path.getsize(path),
            harm_in_flight=self._pending_harm is not None))

    def _after_restore(self, t: int):
        """Rebuild, after a checkpoint restored the state through frame t,
        what the engine keeps beyond the file: the mapping cache store
        learns the current section's mapped keyframe poses (its caches
        are built on the next mapping phase), the global binning and the
        depth LRU start empty, every section is on the device and the cold
        ones page out as after frame t."""
        self.frames_done = t + 1
        self._depth_lru = {}
        self._gcache = self._gcache_key = None
        self._gcache_age = 0
        self._page_pending, self._paged = {}, {}
        self.map_store.reset()
        start = (t // self.bfe) * self.bfe
        if (t + 1) % self.bfe != 0:
            for f in range(start, t + 1):
                if f == 0 or (f + 1) % self.config["map_every"] == 0:
                    self.map_store.poses[f - start] = (
                        self.traj.quats[f].clone(), self.traj.trans[f].clone())
        self._page_cold_sections({t // self.bfe}
                                 | set(self.fixed_section_ids or ()))

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
            with self.trace.span("page.in"):
                self._page_in(i)
            self.trace.count("page.ins", 1)
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
                self.trace.count("page.ins", 1)
                self.stats["section_prefetched_ins"] += 1

    def _page_cold_sections(self, hot):
        """Start the page-out of every device section outside `hot`."""
        if not self.section_paging:
            return
        cold = [i for i in range(len(self.sections))
                if i not in hot and i not in self._paged
                and i not in self._page_pending]
        if not cold:
            return
        with self.trace.span("page.out"):
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

    def _page_cold_finish(self, hot=()):
        """Swap the host copies in for the pending page-outs, except for
        sections that became hot again (they stay on the device)."""
        if not self._page_pending:
            return
        with self.trace.span("page.finish"):
            for i, (host, event) in self._page_pending.items():
                if i in hot or i in self._paged:
                    continue
                self.sections[i] = host
                self._paged[i] = event
                self.trace.count("page.outs", 1)
            self._page_pending = {}

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
            "avg_tracking_frame_s": s["tracking_frame_time_sum"]
            / max(s["tracking_frame_count"], 1),
            "avg_mapping_iter_ms": 1000 * s["mapping_loop_time_sum"]
            / max(s["mapping_loop_iters"], 1),
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
            **{k: s[k] for k in TIMER_SPANS.values()},
            "t_densify": s["t_densify"],
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
