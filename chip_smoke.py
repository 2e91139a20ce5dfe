#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of VTGaussian-SLAM on one NVIDIA GPU.

    python3 chip_smoke.py [--compare-blend DIR ...]

Phases (any failure raises and the exit code is non-zero):
  1. the card's name and power limit, torch / CUDA versions, and the build
     of every kernel from `vtgaussian_slam_tpu_torch/csrc/*.cu` (one nvcc
     per source, all at once; ptxas register / shared-memory report);
  2. the slice: the Replica room0 proxy (680x1200 synthetic frames, 2x
     densification stream, room0's baseframe_every 40) through
     `VTGaussianSLAM` for 5 frames: frame 0 init + map, then 4 x (track 80
     iterations, densify, map 100 iterations). Per frame: wall time split
     into track / densify / map, n_active, pair budget, PSNR and depth L1 of
     a render at the committed pose; then the ATE. The kernel launch counts
     are zeroed just before this run and read just after it;
  2b. the generic route: the same proxy with `tpu.track_cache` and
     `tpu.map_binned` off, so tracking and mapping render from scratch
     every iteration (project, bin, K4, and the backward K5 through the
     inverse map and autograd); the slice's 5 frames at the same
     iteration budgets, printed beside the slice's times for the same
     frames, under the same guards, with its own zeroed launch counts, so
     that the two routes' per-frame PSNR compare like for like. Phases 2
     and 2b (and every run through `run_frames`) print per frame the
     densify count (`num_gs_per_frame_ls`), PSNR and depth L1 at
     `eval_pair_budget`'s budget and at the training budget, and the share
     of tiles at the pair budget of a binning at the committed pose with
     the pairs per tile (mean, p99, max): on the generic route under its
     own name, "generic tiles at the pair budget", since neither package
     records it there;
  2b-w2. why the generic route scores below the default route (ROADMAP
     W2), each variant a fresh engine through `run_frames`:
     1. the generic route on frames 0-1, and again on frames one ulp up
        (depth and colour, as the CPU parity tests nudge them): the
        per-frame |dPSNR| and the frame-1 densify |d| are the card's
        rounding spread for the route;
     2. the same two frames with K4 / K5 swapped for their plain PyTorch
        versions inside this script (`plain_blend`, training only; the
        evaluation renders launch K4): D1, a kernel is at fault when plain
        minus kernels exceeds max(3 x spread, 0.5 dB) on a frame or the
        frame-1 densify counts part by more than 3 x their spread;
     3. the default route with `tpu.importance_binning` off (the depth
        prefix) on phase 2's frames: D2, the cut explains the gap when it
        lands within max(3 x the largest spread, 0.5 dB) of phase 2b;
     4. both routes at the smallest power of two above variant 3's largest
        pair count per tile (`auto_pair_budget` off: no tile truncates, so
        the probe reads 0 and the closed loop holds), each also on frames
        one ulp up: D3, nothing but the cut separates the routes when their
        gap lies within max(3 x the larger route's spread there, 0.5 dB) on
        every frame; then frames 0-2 with the routes' halves swapped
        (generic tracking with binned mapping, cached tracking with generic
        mapping), which half carries what remains;
  2c. section boundaries on the default routes: the same proxy with
     baseframe_every 3 for 10 frames (60 tracking iterations, 80 on the
     first section, 100 mapping iterations, the pair budget's closed loop
     on): boundaries at frames 3, 6 and 9 select the overlapping sections,
     track with the point-to-plane candidate metric and spawn sections 1-3;
     later frames map with the global term over two frozen sections, and
     sections outside the hot set are paged to pinned host memory; after
     the run the truncation probe's harm on the last section and (W5) on
     the global binning at g_mpt and 4 g_mpt. Per
     frame: the section tracked against, track / spawn / densify / map
     seconds, the frame's section's n_active, mpt and the global binning's
     g_mpt, at boundaries the selection and the boundary timers, every
     probe reading and the boost, PSNR and depth L1 of a render at the
     committed pose from the section that holds the frame; then the ATE,
     `final_stats()` and the guards (4 sections, PSNR > 20 dB, ATE < 5 cm,
     finite depth L1, a page-out whose pinned host copy and page-in give
     the section's tensors back to the bit), with zeroed launch counts;
  2d. one boundary on the generic route: `track_cache` / `map_binned` off,
     baseframe_every 2, 4 frames (frame 2 a replica p2p boundary through K4
     + K5; frames 2 and 3 map with the global term over sections (0, 0)),
     under the guards of 2b;
  2e. the CLI and the evaluation: `eval_sequence` over phase 2c's 10
     frames (its `export_params_ls`, taken while one section lay in pinned
     host memory and held to that section's page-out copy) at the training
     budget and at the eval_mode budget (`eval_backend_kwargs`), each
     metric and the wall time printed; then `__main__.main` on
     configs/synthetic/smoke.py (11 frames, 48x64, 3 sections) and
     configs/synthetic/medium.py (30 frames, 240x320, 2 sections) with the
     results under build/chip_smoke_cli/: exit 0, `params_ls.npy` with one
     dict per section and the seven reference keys, `eval/` with the five
     .txt files and one PNG per evaluated frame in each of the four
     folders, "Final Average ATE RMSE" printed; PSNR, MS-SSIM, LPIPS, depth
     L1, ATE and wall time beside the JAX package's numbers (PARITY.md
     round 5); then `eval_mode` on the medium run's results directory from
     its own config.py copy and from the original, under the guards (PSNR
     > 20 dB, ATE < 5 cm, finite depth L1 and LPIPS); every run with its
     own zeroed launch counts;
  2f. the engine's remaining single-card features (every sub-phase with
     its own zeroed launch counts; any failed check exits non-zero):
     a. resume: phase 2c runs with save_checkpoints (checkpoint_interval 6:
        a save after frame 5, its seconds printed apart from the frame's
        split); a checkpoint after frame 9 reads the paged section from
        pinned host memory (held to its page-out copy to the bit); a fresh
        engine resumes from frame 5 through `run` and its trajectory,
        sections and export are held to phase 2c's to the bit, or the first
        frame and quantity that differ are printed (a failure unless a
        truncation-probe reading was in flight at the save); load and save
        seconds, the file's size;
     b. the progress reports: the room0 proxy for 3 frames with use_wandb
        on: `events.jsonl`'s record counts per kind against the loops'
        iteration counts, the progress PSNR beside `evaluate_frame`'s,
        `t_progress` per frame; without matplotlib one "no matplotlib:
        panels skipped" note and no emergency params*.npz;
     c. ScanNet++: `make_config("scannetpp", "proxy")` on synthetic frames at
        584x876 (densification 1168x1752), use_wandb on, init_err_ratio 0,
        6 frames: per frame the probe losses, whether the rescue fired
        (every frame from 2 on), the odometer's relative pose against the
        ground truth, the running ATE (< 5 cm); then
        `rgbd_odometry_multi_scale`'s ms per call at 584x876;
     d. the mesh: `eval_recon` over phase 2c's export at voxel 5/512 m,
        sdf_trunc 0.04 and the eval_mode budget: voxel dims, state GB, peak
        allocated memory, integrate ms per frame, extract / clean / write
        seconds, n_verts / n_faces, the share of pixels the silhouette
        masked at this budget and at mpt 512; then scored against its own
        mesh with 20 2D views (accuracy and completion < 3 cm, 2D depth L1
        < 0.5 cm);
     e. the dense reference: `api.render` on the tiled route (K4) against
        `render_dense` over 20000 Gaussians of phase 2c's last section on a
        128x128 camera (depth and silhouette within 2e-4; rgb parts where
        depths tie in the binning's key, so it is printed, and held within
        2e-4 once the depths are spread apart), and on tests/
        test_rasterizer.py's random scenes; `prune_gaussians` and
        `densify_split_clone` on those Gaussians give the CPU's counts;
  2h. the tile-sharded engine: two ranks spawned on the one card over gloo
     (two processes sharing one H100: their times are not a multi-GPU
     speed), the room0 proxy at full width with tpu.mesh_devices 2 and
     baseframe_every 2 for 4 frames (one boundary: the global term runs
     sharded): rank 0's per-frame split, the all-gather / all-reduce
     milliseconds per call and per iteration at the loops' shapes, the
     ranks' trajectories and exports equal to the bit, and the trajectory's
     largest difference from a one-card run of the same frames (bound
     1e-3 m);
  3. each kernel against its plain PyTorch version on inputs captured from
     the two runs' final states (the track cache and its loss cotangent for
     K1, K2 and K6, one mapping keyframe cache and its cotangent for K3,
     the densify render records for K4, the generic route's records and its
     mapping-loss cotangent for K5), on 128 tiles (the 64 fullest + 64
     random), with the tolerance stated; K4 also on the generic route's
     records, the input of all its launches but densify's, and on phase
     2e's eval render of phase 2c's last section at its last frame, at the
     training budget and at the eval_mode budget, and on phase 2f-c's
     render of the ScanNet++ proxy at 584x876; K1 and K3 also
     on phase 2c's global binning (the frozen sections and the current
     one, at g_mpt) with the global term's loss cotangent, and K2 also on
     the track cache of phase 2c's last boundary frame; K1, K2 and K3 also
     with the new operands: on half of the tracking and of the mapping
     cache's tiles in a shuffled order and 8 rows of count 0 (the tile-id
     operand, with the loss cotangents' rows; no engine path passes it)
     and on rank 1's tile shard of phase 2h's one-card state at
     its nonzero tile_offset; each with that input's own time, bound and
     step counts (and launches, for the new operands'); K6, which no
     engine path launches, also runs through `splat_blend(grad_mode="all")` under autograd, held
     against the plain rows and against K2's dR, dt;
     for K2 where its disagreement comes from (kernel and plain f32 each
     against the plain version in f64, and the TF32 mirror of the sums);
     then the kernel's time at the full shapes (CUDA events around one
     wrapper call, the median of 10; 20 calls back to back beside it), the
     plain version's time over all tiles (in tile batches), and the
     least time the card could take for the same work (the pairs and
     slots these inputs make the kernel walk and blend, read from the
     plain walk's masks; see FLOPS_WALKED); for K1 to K5 the
     counts that explain their design, for the 8 x 4 pixel blocks the
     kernels' warps own: the (block, slot) steps walked, those the slot's
     box keeps, those in which some lane blends (and the same per 16-slot
     sub-chunk for the backwards); a kept pair outside its slot's box
     raises; every kernel launched twice must give the same bits; then
     K5/K4, K2/K1 and K3/K1 of this run; with `--compare-blend DIR`, K4 of
     the `blend.cu` in DIR (another version of the source, its `walk.cuh`
     beside it, with this tree's C interface: the tile-id and tile-offset
     operands) on both of K4's inputs: whether the two outputs are equal
     to the bit, the largest difference, and both times; then the
     mapping-loss kernels (`ML`, csrc/maploss.cu, forward and backward)
     on the newest keyframe cache's render and its keyframe: their loss,
     im_loss, depth_loss and gradients, and the plain mapping branch's
     (its PyTorch ops), each within the f32 rounding bound of the
     branch's f64 values (tests/test_torch_map_loss.py), a repeated launch
     equal to the bit, the times of forward + backward, of the forward
     and of the plain branch, and the bound; then the slot kernels (`SG`
     the slot gather, `SI` the slot-inverse sum, csrc/slots.cu) on the
     newest keyframe cache and K3's rows on it: each equal to its plain
     version to the bit and to itself on a repeated launch, its time, the
     time of the PyTorch composition it replaced, and the bound by bytes;
  3b. the device-busy share of the loops (`[busy]` lines): ten iterations
     each of the default tracking loop, the default mapping loop, the
     generic tracking loop and the replica boundary tracking loop with its
     p2p target (phase 2c's frame 9) on the runs' final states, once timed by the
     host clock alone and once under `torch.profiler`: the summed device
     time over the unprofiled wall time, the launches per iteration and the
     five kernels with the most device time;
  4. a `{"kernels": [...]}` line, K1-K6, ML, SG and SI (launches: the sum
     over the engine runs, phase 2e's evaluations and CLI runs and phases
     2f and 2h);
     the card line; and as the
     last line
     `{"ok": true, "device": {...}}`.

It needs one CUDA card and the repository checkout around it: without
either it prints the reason and exits non-zero.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
NUM_FRAMES = 5
GENERIC_FRAMES = NUM_FRAMES   # the generic route on the slice's frames
BOUNDARY_BFE, BOUNDARY_FRAMES = 3, 10     # phase 2c: four sections
GENERIC_BFE, GENERIC_BOUNDARY_FRAMES = 2, 4   # phase 2d: one boundary
TRACK_ITERS = 80      # room0 base1_num_iters
MAP_ITERS = 100       # room0 mapping num_iters
BUSY_ITERS = 10       # iterations of each loop under the profiler
CLI_WORKDIR = os.path.join(REPO, "build", "chip_smoke_cli")
CKPT_WORKDIR = os.path.join(REPO, "build", "chip_smoke_ckpt")
F_WORKDIR = os.path.join(REPO, "build", "chip_smoke_2f")
RESUME_FROM = 5       # phase 2c saves after frame 5; 2f-a resumes there
PROGRESS_FRAMES = 3   # phase 2f-b
PP_FRAMES = 6         # phase 2f-c: the ScanNet++ proxy
DENSE_N, DENSE_HW = 20000, 128    # phase 2f-e
SHARDED_BFE, SHARDED_FRAMES, SHARDED_RANKS = 2, 4, 2   # phase 2h
SHARDED_WORKDIR = os.path.join(REPO, "build", "chip_smoke_2h")
SHARDED_TIMEOUT_S = 600
# the JAX package's final numbers on the synthetic configs (PARITY.md,
# round 5, on a TPU v5e; MS-SSIM from round 2; LPIPS not recorded), and
# the spread of its recorded runs (rounds 1-5) that the port should land in
JAX_CLI = {
    "smoke": dict(psnr=43.42, ms_ssim=1.000, depth_l1_cm=None, ate_cm=2.55,
                  psnr_range=(41.7, 44.2), ate_range_cm=(2.5, 3.0),
                  l1_range_cm=None),
    "medium": dict(psnr=52.21, ms_ssim=None, depth_l1_cm=1.06, ate_cm=0.33,
                   psnr_range=(50.7, 52.2), ate_range_cm=(0.30, 0.43),
                   l1_range_cm=(0.6, 1.1)),
}
PARAM_KEYS = ("means3D", "rgb_colors", "unnorm_rotations", "logit_opacities",
              "log_scales", "cam_unnorm_rots", "cam_trans")

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and fp32 outside the tensor
# cores; the kernels do fp32 vector math and exp.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# fp32 operations of csrc/splat.cu and csrc/blend.cu, counted as the peak
# counts them: an add, multiply, min/max or compare is one, a fused
# multiply-add two (67e12 = 132 SMs x 128 lanes x 2 x 1.98 GHz). exp, a
# reciprocal or a division counts one, though the card issues them at a
# quarter of the fp32 rate, so the count stays a floor. Per pair a pixel
# walks (its slot is live and the pixel still open): dx, dy, the power (9),
# exp, opacity x exp, the alpha clamp and the two cuts -> 16. Per pair that
# is blended (kept and before the stop), on top of that:
#   K1: T update and stop test (3), weight, 6 channel sums (11)      -> 15
#   K2: T and stop (3), weight, g.c (11), H (2), d alpha (6), d power,
#       the 6 moment terms (9) and their 6 pixel sums                -> 39
#   K3: the same up to d power (24), 7 terms (9) and their 7 sums    -> 40
#   K4: T and stop (3), weight, 8 channel sums (16)                  -> 20
#   K5: T and stop (3), weight, g.c over 8 channels (16), H (2),
#       d alpha (6), d power, the 5 moment terms (8), d opacity (1),
#       8 colour terms (8) and their 14 pixel sums                   -> 60
#   K6: K2's 39, plus d opacity (1), 3 colour terms (3) and their
#       4 pixel sums                                                 -> 47
# Per slot some pixel walks: the projection (72; K1 and the splat
# backwards) and the backward's chain: K2 conic + Jacobian + mean chain
# and the 12 pose sums (+118), K3 conic chain and the d logit / d
# log-scale (+35), K6 K2's chain without the pose sums (+97) and the
# d logit / d log-scale (+11); per record K5 walks, the moments -> mean2d
# and conic rows (9).
FLOPS_WALKED = {"K1": 16, "K2": 16, "K3": 16, "K4": 16, "K5": 16, "K6": 16}
FLOPS_BLENDED = {"K1": 15, "K2": 39, "K3": 40, "K4": 20, "K5": 60, "K6": 47}
FLOPS_SLOT = {"K1": 72, "K2": 190, "K3": 107, "K4": 0, "K5": 9, "K6": 180}
MAX_SCALED_ERR = 2e-2   # see check_close
# phase 2b-w2: frames of variants 1 and 2 and of variant 4's mixed routes,
# the PSNR floor of its decisions' yardstick max(3 x spread, floor), and the
# largest pair count per tile counted (variant 4's budget at most)
W2_SPREAD_FRAMES = 2
W2_MIXED_FRAMES = 3     # variant 4's routes with their halves swapped
W2_FLOOR_DB = 0.5
COUNT_CAP = 32768


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def room0_proxy_config():
    from configs.common import make_config
    config = make_config("replica", "room0proxy", seed=2)
    config["use_wandb"] = False
    config["data"] = dict(
        dataset_name="synthetic",
        synthetic=dict(num_frames=40, height=680, width=1200, seed=0,
                       motion_scale=0.05),
        sequence="room0proxy", desired_image_height=680,
        desired_image_width=1200, densification_image_height=1360,
        densification_image_width=2400, start=0, end=-1, stride=1,
        num_frames=-1)
    return config


def generic_route_config():
    """The room0 proxy with the frozen-binning caches off: tracking and
    mapping take the generic autodiff route (K4 forward, K5 backward)."""
    config = room0_proxy_config()
    config["tpu"]["track_cache"] = False
    config["tpu"]["map_binned"] = False
    return config


def train_quality(engine, t):
    """(PSNR dB, depth L1 m) of frame t as `evaluate_frame` scores it, but
    rendered at the training budget (`engine.backend_kwargs`) instead of
    `eval_pair_budget`'s."""
    import torch
    from vtgaussian_slam_tpu_torch.core.losses import render_slam
    from vtgaussian_slam_tpu_torch.eval.evaluate import frame_metrics
    color_np, depth_np, _, _ = engine.dataset[t]
    sec = engine._resident(t // engine.bfe)
    with torch.no_grad():
        r = render_slam(sec.params, sec.active_mask(), engine.traj.quats[t],
                        engine.traj.trans[t], engine.cam,
                        engine.backend_kwargs)
    m = frame_metrics(r, color_np, depth_np, with_ssim=False)
    return m["psnr"], m["l1"]


def budget_counts(engine, t, mpt):
    """Frame t's section binned at frame t's committed pose
    (`binning.bin_gaussians`): the share of image tiles whose pair count
    reaches `mpt` under each select (they keep different pairs of a full
    tile, never a different count: asserted), and the mean, 99th
    percentile and maximum of the pairs per tile, counted up to COUNT_CAP. Neither package records the share on the
    generic route: the engines measure it only on their caches."""
    import torch
    from vtgaussian_slam_tpu_torch.core.track_cache import project_at
    from vtgaussian_slam_tpu_torch.ops.rasterizer.binning import bin_gaussians
    sec = engine._resident(t // engine.bfe)
    cam = engine.cam
    tx, ty = -(-cam.width // 16), -(-cam.height // 16)
    span = engine.backend_kwargs["span_cap"]
    proj = project_at(sec.params, sec.active_mask(), engine.traj.quats[t],
                      engine.traj.trans[t], cam)
    share = {sel: float((bin_gaussians(proj, 16, span, tx, ty, mpt,
                                       select=sel).counts >= mpt)
                        .double().mean())
             for sel in ("importance", "depth")}
    assert share["importance"] == share["depth"], share
    raw = bin_gaussians(proj, 16, span, tx, ty, COUNT_CAP).counts.double()
    return dict(share=share["depth"], mean=float(raw.mean()),
                p99=float(torch.quantile(raw, 0.99)), max=int(raw.max()))


def run_frames(engine, n, wrappers, valid0, tag, train=contextlib.nullcontext):
    """Drive `engine.process_frame` for frames 0..n-1, each inside the
    context `train()` makes, with every kernel count zeroed just before and
    read just after; print the per-frame split, the densify count, the
    quality at `eval_pair_budget`'s and at the training budget, the
    share of tiles at the pair budget at the committed pose and the guards.
    Returns (launches, per-frame times, quality: per-frame lists under
    psnr, l1, psnr_train, l1_train, densified, share, mean, p99, max, mpt,
    and the ATE under ate)."""
    import numpy as np
    import torch
    from vtgaussian_slam_tpu_torch.eval.evaluate import eval_pair_budget
    zeroed(wrappers)
    rows = []
    t_run = time.time()
    count_s = 0.0
    for t in range(n):
        with train():
            engine.process_frame(t)
        mpt = engine.backend_kwargs["max_pairs_per_tile"]
        t0 = time.time()
        counts = budget_counts(engine, t, mpt)
        count_s += time.time() - t0
        rows.append((t, engine.frame_times[t], engine.sections[0].n_active,
                     mpt, counts))
    torch.cuda.synchronize()
    run_s = time.time() - t_run - count_s
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"[{tag}] {n} frames in {run_s:.2f} s (the tile counts' "
          f"{count_s:.2f} s apart); launches {launches}")
    # the initial count, then one densify per frame (one section)
    dens = engine.num_gs_per_frame_ls
    q = {k: [] for k in ("psnr", "l1", "psnr_train", "l1_train", "densified",
                         "share", "mean", "p99", "max", "mpt")}
    for t, ft, n_act, mpt, c in rows:
        psnr, l1 = engine.evaluate_frame(t)
        psnr_tr, l1_tr = train_quality(engine, t)
        e_mpt = eval_pair_budget(engine.sections[0].n_active, engine.cam.height,
                                 engine.cam.width, engine.config["tpu"])[
                                     "max_pairs_per_tile"]
        for k, v in (("psnr", psnr), ("l1", l1), ("psnr_train", psnr_tr),
                     ("l1_train", l1_tr), ("densified", dens[t]),
                     ("share", c["share"]), ("mean", c["mean"]),
                     ("p99", c["p99"]),
                     ("max", c["max"]), ("mpt", mpt)):
            q[k].append(v)
        print(f"[{tag} frame {t}] track {ft['track']:.3f} s densify "
              f"{ft['densify']:.3f} s map {ft['map']:.3f} s ({stage(ft)}) | "
              f"n_active {n_act} ({'initial' if t == 0 else 'densified'} "
              f"{dens[t]}) | mpt {mpt} | PSNR {psnr:.2f} dB, depth L1 "
              f"{l1 * 100:.3f} cm at the eval budget (mpt {e_mpt}); "
              f"{psnr_tr:.2f} dB, {l1_tr * 100:.3f} cm at the training "
              f"budget | tiles at the pair budget {c['share']:.4f} (both "
              f"selects), pairs per tile mean {c['mean']:.0f} p99 "
              f"{c['p99']:.0f} max {c['max']}")
    ate = q["ate"] = engine.ate(n)
    share = (f"tracking tiles at the pair budget, max share "
             f"{engine.stats['tile_truncation_frac_max']:.4f}"
             if engine.track_cached else
             f"generic tiles at the pair budget, max share "
             f"{max(q['share']):.4f} (chip_smoke's binning at each frame's "
             f"committed pose)")
    print(f"[{tag}] ATE {ate * 100:.4f} cm (bound < 5 cm); min PSNR "
          f"{min(q['psnr']):.2f} dB (bound > 20 dB); n_active "
          f"{engine.sections[0].n_active} (bound >= {valid0}); {share}")
    vals = q["psnr"] + q["l1"] + q["psnr_train"] + q["l1_train"] + [ate]
    assert all(np.isfinite(v) for v in vals), vals
    assert engine.sections[0].n_active >= valid0
    assert ate < 0.05, ate
    assert min(q["psnr"]) > 20.0, q["psnr"]
    return launches, [ft for _, ft, _, _, _ in rows], q


@contextlib.contextmanager
def one_ulp_frames():
    """Every frame the port's synthetic dataset returns, one ulp up: depth
    where valid, and colour (the "both" nudge of the CPU parity tests'
    `one_ulp_frames`); restored on exit."""
    import numpy as np
    from vtgaussian_slam_tpu_torch.datasets.synthetic import \
        SyntheticRoomDataset
    get = SyntheticRoomDataset.__getitem__

    def nudged(self, index):
        c, d, K, pose = get(self, index)
        d = np.where(d > 0, np.nextafter(d, np.float32(np.inf)),
                     d).astype(d.dtype)
        c = np.nextafter(c, np.float32(np.inf)).astype(c.dtype)
        return c, d, K, pose

    SyntheticRoomDataset.__getitem__ = nudged
    try:
        yield
    finally:
        SyntheticRoomDataset.__getitem__ = get


@contextlib.contextmanager
def plain_blend():
    """The tiled renderer's K4 and K5 (`tiled.BlendGather`'s forward and
    backward and the render without gradient) replaced by their plain
    PyTorch versions on the card, 64 tiles at a time; the wrappers are
    restored on exit. Phase 2b-w2's variant 2 alone runs inside it: the
    package launches K4 / K5 on every CUDA tensor."""
    import torch
    from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_blend as cb
    from vtgaussian_slam_tpu_torch.ops.rasterizer import tiled
    fwd, bwd = tiled.blend_forward, tiled.blend_backward

    def forward(recs, counts, tiles_x, n_channels=8):
        return torch.cat([cb.blend_forward_plain(
            recs[b], counts[b], tiles_x, n_channels, b)
            for b in batched(recs.shape[0], 64)])

    def backward(recs, counts, out, g, tiles_x):
        return torch.cat([cb.blend_backward_plain(
            recs[b], counts[b], out[b], g[b], tiles_x, b)
            for b in batched(recs.shape[0], 64)])

    tiled.blend_forward, tiled.blend_backward = forward, backward
    try:
        yield
    finally:
        tiled.blend_forward, tiled.blend_backward = fwd, bwd


def w2_run(config, n, wrappers, valid0, tag, train=contextlib.nullcontext):
    """One phase 2b-w2 variant: a fresh engine on `config` for n frames
    (`run_frames`); the engine is freed. Returns (launches, quality)."""
    import torch
    from vtgaussian_slam_tpu_torch.core.pipeline import VTGaussianSLAM
    eng = VTGaussianSLAM(config, device="cuda")
    launches, _, q = run_frames(eng, n, wrappers, valid0, tag, train)
    eng.close()
    del eng
    torch.cuda.empty_cache()
    return launches, q


def w2_phase(wrappers, valid0, q_default, q_generic):
    """Phase 2b-w2: why the generic route scores below the default route
    (ROADMAP W2). q_default / q_generic: phase 2's and phase 2b's per-frame
    quality on the same frames. Prints each variant per frame and the
    decisions D1-D3; returns the launches of every variant, summed."""
    import numpy as np
    yard = lambda spread: max(3.0 * spread, W2_FLOOR_DB)
    fmt = lambda xs, nd=2: " / ".join(f"{x:.{nd}f}" for x in xs)

    def config_of(generic, **tpu):
        c = generic_route_config() if generic else room0_proxy_config()
        c["tracking"]["base1_num_iters"] = TRACK_ITERS
        c["mapping"]["num_iters"] = MAP_ITERS
        c["tpu"].update(tpu)
        return c

    runs = []
    # variant 1: the card's rounding spread on the generic route
    l, ref = w2_run(config_of(True), W2_SPREAD_FRAMES, wrappers, valid0,
                    "w2 v1 generic")
    runs.append(l)
    with one_ulp_frames():
        l, ulp = w2_run(config_of(True), W2_SPREAD_FRAMES, wrappers, valid0,
                        "w2 v1 generic, frames one ulp up")
    runs.append(l)
    spread = [abs(a - b) for a, b in zip(ulp["psnr"], ref["psnr"])]
    spread_tr = [abs(a - b) for a, b in zip(ulp["psnr_train"],
                                            ref["psnr_train"])]
    d_spread = abs(ulp["densified"][1] - ref["densified"][1])
    print(f"[2b-w2 v1] one-ulp spread of the generic route (K4 + K5), "
          f"frames 0-{W2_SPREAD_FRAMES - 1}: |dPSNR| "
          f"{fmt(spread)} dB at the eval budget, {fmt(spread_tr)} dB at the "
          f"training budget; frame-1 densify {ref['densified'][1]} against "
          f"{ulp['densified'][1]} (|d| {d_spread})")

    # variant 2: the same route with K4 / K5 swapped for the plain versions
    l, plain = w2_run(config_of(True), W2_SPREAD_FRAMES, wrappers, valid0,
                      "w2 v2 generic, plain K4 / K5 (training only)",
                      train=plain_blend)
    runs.append(l)
    assert l["K4"] == l["K5"] == 0, l     # the frames ran the plain versions
    gap = [p - r for p, r in zip(plain["psnr"], ref["psnr"])]
    gap_tr = [p - r for p, r in zip(plain["psnr_train"], ref["psnr_train"])]
    d_gap = abs(plain["densified"][1] - ref["densified"][1])
    d1 = (any(abs(g) > yard(s) for g, s in zip(gap, spread))
          or d_gap > 3 * d_spread)
    print(f"[2b-w2 v2] plain: PSNR {fmt(plain['psnr'])} dB (kernels "
          f"{fmt(ref['psnr'])}); plain - kernels {fmt(gap)} dB at the eval "
          f"budget (limits {fmt(yard(x) for x in spread)}), {fmt(gap_tr)} "
          f"dB at the training budget; frame-1 densify {plain['densified'][1]}"
          f" against {ref['densified'][1]} (|d| {d_gap}, limit "
          f"{3 * d_spread}) -> D1: a kernel is at fault: {d1}")

    # variant 3: the default route on the generic route's cut
    l, depth = w2_run(config_of(False, importance_binning=False), NUM_FRAMES,
                      wrappers, valid0, "w2 v3 default, depth prefix")
    runs.append(l)
    lim = yard(max(spread))
    to_generic = [a - b for a, b in zip(depth["psnr"], q_generic["psnr"])]
    d2 = all(abs(x) <= lim for x in to_generic)
    print(f"[2b-w2 v3] PSNR per frame at the eval budget: default "
          f"(importance) {fmt(q_default['psnr'])}; default (depth prefix) "
          f"{fmt(depth['psnr'])}; generic {fmt(q_generic['psnr'])} dB; "
          f"densified {q_default['densified'][1:]} / {depth['densified'][1:]}"
          f" / {q_generic['densified'][1:]}; tiles at the pair budget "
          f"{fmt(depth['share'], 4)}; depth prefix - generic {fmt(to_generic)} "
          f"dB (limit {lim:.2f}) -> D2: the cut explains the gap: {d2}")

    # variant 4: both routes at a budget that truncates no tile, each
    # route's spread there, and the two halves of each route swapped
    top = max(depth["max"])
    cover = 512
    while cover <= top and cover < COUNT_CAP:
        cover *= 2
    print(f"[2b-w2 v4] variant 3's pairs per tile: p99 "
          f"{fmt(depth['p99'], 0)}, max {depth['max']} -> covering budget "
          f"mpt {cover} (auto_pair_budget off: at a budget no tile reaches, "
          f"the probe reads 0 and the closed loop holds)")
    q4, ulp4 = {}, {}
    for name, track_cache, map_binned in (
            ("default", True, True), ("generic", False, False),
            ("generic tracking, binned mapping", False, True),
            ("cached tracking, generic mapping", True, False)):
        cfg = config_of(False, max_pairs_per_tile=cover,
                        auto_pair_budget=False, track_cache=track_cache,
                        map_binned=map_binned)
        mixed = track_cache != map_binned
        l, q4[name] = w2_run(cfg, W2_MIXED_FRAMES if mixed else NUM_FRAMES,
                             wrappers, valid0, f"w2 v4 {name}, mpt {cover}")
        runs.append(l)
        if name in ("default", "generic"):
            with one_ulp_frames():
                l, ulp4[name] = w2_run(
                    cfg, NUM_FRAMES, wrappers, valid0,
                    f"w2 v4 {name}, mpt {cover}, frames one ulp up")
            runs.append(l)
    spread4 = [max(abs(ulp4[r]["psnr"][t] - q4[r]["psnr"][t])
                   for r in ulp4) for t in range(NUM_FRAMES)]
    lim4 = [yard(x) for x in spread4]
    gap4 = [a - b for a, b in zip(q4["default"]["psnr"],
                                  q4["generic"]["psnr"])]
    d3 = all(abs(x) <= y for x, y in zip(gap4, lim4))
    for name, q in q4.items():
        print(f"[2b-w2 v4] mpt {cover}, {name}: PSNR {fmt(q['psnr'])} dB, "
              f"ATE {q['ate'] * 100:.4f} cm, densified {q['densified'][1:]},"
              f" tiles at the pair budget {fmt(q['share'], 4)}")
    print(f"[2b-w2 v4] mpt {cover}: one-ulp spread (the larger of the two "
          f"routes') {fmt(spread4)} dB; default - generic {fmt(gap4)} dB "
          f"(limits {fmt(lim4)}; at mpt 512 "
          f"{fmt(a - b for a, b in zip(q_default['psnr'], q_generic['psnr']))}"
          f") -> D3: nothing but the cut separates the routes: {d3}")
    vals = [x for q in (ref, ulp, plain, depth, *q4.values(), *ulp4.values())
            for x in q["psnr"] + q["psnr_train"]]
    assert all(np.isfinite(v) for v in vals), vals
    return {k: sum(r[k] for r in runs) for k in wrappers}


def run_boundaries(engine, n, wrappers, valid0, tag, n_sections):
    """Drive frames 0..n-1 across section boundaries with every kernel
    count zeroed just before and read just after; print per frame the
    section, the phase split, the pair budgets, the selections, the probe
    readings and the quality, then the ATE and `final_stats()`; check the
    guards. Returns (launches, the device tensors of each section at the
    start of its page-out)."""
    import numpy as np
    import torch
    from vtgaussian_slam_tpu_torch.models.gaussians import section_tensors
    zeroed(wrappers)
    rows, refs, n_probe = [], {}, 0
    bfe = engine.bfe
    t_run = time.time()
    count_s = 0.0
    for t in range(n):
        engine.process_frame(t)
        engine.maybe_checkpoint(t)
        for i in engine._page_pending:
            if i not in refs:
                refs[i] = [x.clone() for x in
                           section_tensors(engine.sections[i])]
        gc = engine._gcache
        mpt = engine.backend_kwargs["max_pairs_per_tile"]
        t0 = time.time()
        counts = budget_counts(engine, t, mpt)
        count_s += time.time() - t0
        rows.append(dict(
            t=t, ft=engine.frame_times[t], sec=engine.section_ids[t],
            n=engine.sections[t // bfe].n_active, mpt=mpt, counts=counts,
            g_mpt=None if gc is None else gc.tab.shape[1],
            fixed=engine.fixed_section_ids,
            probes=engine.probe_log[n_probe:], boost=engine._mpt_boost,
            corr=((engine.tracking_corr[-1:], engine.earliest_corr[-1:])
                  if t and t % bfe == 0 else None),
            paged=engine.paged_sections()))
        n_probe = len(engine.probe_log)
    engine._page_cold_finish()
    torch.cuda.synchronize()
    run_s = time.time() - t_run - count_s
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"[{tag}] {n} frames in {run_s:.2f} s (the tile counts' "
          f"{count_s:.2f} s apart); launches {launches}")
    psnrs, l1s = [], []
    for r in rows:
        psnr, l1 = engine.evaluate_frame(r["t"])
        psnrs.append(psnr)
        l1s.append(l1)
        ft = r["ft"]
        probes = "; ".join(f"mpt {m} harm {h:.5f} -> boost {b}"
                           for m, h, b in r["probes"]) or "none read"
        print(f"[{tag} frame {r['t']}] section {r['sec']} | track "
              f"{ft['track']:.3f} s spawn {ft['spawn']:.3f} s densify "
              f"{ft['densify']:.3f} s map {ft['map']:.3f} s | n_active "
              f"{r['n']} ({stage(ft)}) | mpt {r['mpt']} g_mpt {r['g_mpt']} | "
              f"probes "
              f"{probes}; boost {r['boost']} | PSNR {psnr:.2f} dB | depth L1 "
              f"{l1 * 100:.3f} cm | tiles at the pair budget "
              f"{r['counts']['share']:.4f} at the committed pose (pairs per "
              f"tile p99 {r['counts']['p99']:.0f} max {r['counts']['max']}) | "
              f"host sections {r['paged']}"
              + (f" | checkpoint saved in {ft['checkpoint']:.3f} s (outside "
                 f"the split)" if "checkpoint" in ft else ""))
        if r["corr"] is not None:
            timers = ", ".join(f"{k} {v:.3f}" for k, v in ft["timers"].items())
            print(f"  boundary: tracking_corr {r['corr'][0]} earliest_corr "
                  f"{r['corr'][1]} fixed_section_ids {r['fixed']} | {timers}")
    ate = engine.ate(n)
    print(f"[{tag}] ATE {ate * 100:.4f} cm over {n} frames (bound < 5 cm); "
          f"min PSNR {min(psnrs):.2f} dB (bound > 20 dB); "
          f"{len(engine.sections)} sections (want {n_sections}), n_active "
          f"{[s.n_active for s in engine.sections]}")
    print(f"[{tag}] final_stats " + json.dumps(engine.final_stats()))
    if not engine.track_cached:
        print(f"[{tag}] generic tiles at the pair budget, max share "
              f"{max(r['counts']['share'] for r in rows):.4f} (chip_smoke's "
              f"binning at each frame's committed pose; final_stats' "
              f"tile_truncation_frac_max reads only the global binning here)")
    vals = psnrs + l1s + [ate]
    assert all(np.isfinite(v) for v in vals), vals
    assert len(engine.sections) == n_sections, len(engine.sections)
    assert engine.sections[0].n_active >= valid0
    assert ate < 0.05, ate
    assert min(psnrs) > 20.0, psnrs
    return launches, refs


def stage(ft):
    """A frame's load (through the prefetcher) and its staging on the
    device (seconds, from the frame's timers)."""
    g = lambda k: ft["timers"].get(k, 0.0)
    return f"load {g('t_dataset'):.3f} stage {g('t_stage'):.3f}"


def check_paging(engine, refs, tag):
    """A paged-out section lies in pinned host memory, equal to the bit to
    its device tensors at the start of its page-out, and a page-in gives
    them back."""
    import torch
    from vtgaussian_slam_tpu_torch.models.gaussians import section_tensors
    cold = [i for i in engine.paged_sections() if i in refs]
    assert engine.stats["section_page_outs"] >= 1 and cold, (
        engine.stats["section_page_outs"], engine.paged_sections())
    i = cold[0]
    host = section_tensors(engine.host_section(i))
    pinned = all(x.device.type == "cpu" and x.is_pinned() for x in host)
    same_host = all(torch.equal(a.cpu(), b) for a, b in zip(refs[i], host))
    back = section_tensors(engine._sec(i))
    same_back = all(x.device.type == "cuda" and torch.equal(a, x)
                    for a, x in zip(refs[i], back))
    print(f"[{tag}] paging: section {i} on the host, pinned {pinned}, equal "
          f"to its device tensors at page-out {same_host}; paged back in, "
          f"equal {same_back}; page-outs {engine.stats['section_page_outs']}, "
          f"page-ins {engine.stats['section_page_ins']}")
    assert pinned and same_host and same_back


class Tee:
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, text):
        self.parts.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()

    def text(self):
        return "".join(self.parts)


def zeroed(wrappers):
    for w in wrappers.values():
        w.launches = 0


def read_counts(wrappers):
    return {k: w.launches for k, w in wrappers.items()}


def check_export(params_ls, engine, refs, tag):
    """`export_params_ls` of an engine with a section in pinned host
    memory: one dict per section with the reference keys, and the paged
    section's arrays equal to the bit to its tensors at page-out."""
    import numpy as np
    assert len(params_ls) == len(engine.sections)
    paged = [i for i in engine.paged_sections() if i in refs]
    assert paged, engine.paged_sections()
    for p in params_ls:
        assert tuple(sorted(p)) == tuple(sorted(PARAM_KEYS)), sorted(p)
    for i in paged:
        n = engine.sections[i].n_active
        for k, ref in zip(PARAM_KEYS[:5], refs[i][:5]):
            assert np.array_equal(params_ls[i][k], ref[:n].cpu().numpy()), k
    print(f"[{tag}] export_params_ls: {len(params_ls)} sections, section(s) "
          f"{paged} exported from pinned host memory, equal to the bit to "
          f"their tensors at page-out; trajectory "
          f"{params_ls[0]['cam_trans'].shape}")


def eval_phase(engine, params_ls, wrappers, lpips, tag, backend_kwargs):
    """`eval_sequence` over an engine run's frames and exported params at
    `backend_kwargs`, with zeroed launch counts: the metrics, the wall
    time and the launches."""
    import torch
    from vtgaussian_slam_tpu_torch.eval.evaluate import eval_sequence
    cfg = engine.config
    zeroed(wrappers)
    t0 = time.time()
    res = eval_sequence(
        engine.dataset, params_ls, engine.frames_done,
        os.path.join(CLI_WORKDIR, "".join(c if c.isalnum() else "_"
                                          for c in tag), "eval"),
        sil_thres=cfg["mapping"]["sil_thres"],
        mapping_iters=cfg["mapping"]["num_iters"],
        add_new_gaussians=cfg["mapping"]["add_new_gaussians"],
        eval_every=1, baseframe_every=engine.bfe, save_frames=True,
        lpips_fn=lpips, backend_kwargs=backend_kwargs, device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_counts(wrappers)
    print(f"[{tag}] eval_sequence over {engine.frames_done} frames at mpt "
          f"{backend_kwargs['max_pairs_per_tile']}: PSNR {res['psnr']:.4f} "
          f"dB, MS-SSIM {res['ms_ssim']:.6f}, LPIPS {res['lpips']:.6f} "
          f"({lpips.source}), depth L1 {res['depth_l1'] * 100:.4f} cm, depth "
          f"RMSE {res['depth_rmse'] * 100:.4f} cm, ATE "
          f"{res['ate_rmse'] * 100:.4f} cm | {wall:.2f} s "
          f"({wall / engine.frames_done:.3f} s per frame, 4 PNGs each) | "
          f"launches {launches}")
    guards(res, tag)
    assert launches["K4"] == engine.frames_done, launches
    return res, launches


def guards(res, tag):
    import numpy as np
    ok = (res["psnr"] > 20.0 and res["ate_rmse"] < 0.05
          and np.isfinite(res["depth_l1"]) and np.isfinite(res["lpips"]))
    if not ok:
        raise AssertionError(f"[{tag}] outside the guards: {res}")


def cli_run(argv, wrappers, tag):
    """`__main__.main(argv)` with zeroed launch counts and its stdout kept:
    (exit code, stdout, wall seconds, launches)."""
    import contextlib
    import torch
    from vtgaussian_slam_tpu_torch.__main__ import main as cli_main
    zeroed(wrappers)
    tee = Tee(sys.stdout)
    print(f"[{tag}] python -m vtgaussian_slam_tpu_torch {' '.join(argv)}")
    t0 = time.time()
    with contextlib.redirect_stdout(tee):
        rc = cli_main(argv)
    torch.cuda.synchronize()
    return rc, tee.text(), time.time() - t0, read_counts(wrappers)


def check_results_dir(rdir, n_frames, n_sections, out, tag):
    """The CLI's contract on disk and in its output; returns the metrics
    read back from eval/ and the printed ATE."""
    import numpy as np
    params_ls = np.load(os.path.join(rdir, "params_ls.npy"), allow_pickle=True)
    assert len(params_ls) == n_sections, len(params_ls)
    for p in params_ls:
        assert tuple(sorted(p)) == tuple(sorted(PARAM_KEYS)), sorted(p)
        assert p["cam_trans"].shape == (1, 3, n_frames), p["cam_trans"].shape
    m = {}
    for k in ("psnr", "rmse", "l1", "ssim", "lpips"):
        m[k] = np.atleast_1d(np.loadtxt(os.path.join(rdir, "eval", f"{k}.txt")))
        assert m[k].shape == (n_frames,), (k, m[k].shape)
    for sub in ("rendered_rgb", "rendered_depth", "rgb", "depth"):
        got = len(os.listdir(os.path.join(rdir, "eval", sub)))
        assert got == n_frames, (sub, got)
    assert "Final Average ATE RMSE" in out
    ate_cm = float(out.split("Final Average ATE RMSE:")[1].split("cm")[0])
    res = {"psnr": float(m["psnr"].mean()), "ms_ssim": float(m["ssim"].mean()),
           "lpips": float(m["lpips"].mean()),
           "depth_l1": float(m["l1"].mean()), "ate_rmse": ate_cm / 100}
    guards(res, tag)
    return res


def event_ms(fn, iters: int = 10, warmup: int = 2, per: int = 1) -> float:
    """Device time of one call by CUDA events: the median over `iters` runs
    of `per` back-to-back calls, divided by `per`."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per)
    times.sort()
    return times[len(times) // 2]


def batched(T: int, size: int):
    import torch
    for s in range(0, T, size):
        yield torch.arange(s, min(T, s + size), device="cuda")


def pick_tiles(counts, k: int = 64, seed: int = 0):
    """The k fullest tiles plus k others drawn at random."""
    import torch
    order = torch.argsort(counts.long(), descending=True, stable=True)
    top = order[:k]
    rest = order[k:]
    g = torch.Generator().manual_seed(seed)
    pick = rest[torch.randperm(rest.numel(), generator=g)[:k].to(rest.device)]
    return torch.sort(torch.cat([top, pick])).values


def scaled_errors(got, ref):
    """|got - ref| scaled per last-axis channel by that channel's max |ref|:
    (max, 99.9th percentile, median, max abs error)."""
    import torch
    got = got.double().reshape(-1, got.shape[-1])
    ref = ref.double().reshape(-1, ref.shape[-1])
    scale = torch.clamp(ref.abs().amax(0), min=1e-30)
    scaled = ((got - ref).abs() / scale).reshape(-1)
    sample = scaled[torch.randperm(scaled.numel(),
                                   device=scaled.device)[:1 << 24]]
    return (scaled.max().item(), torch.quantile(sample, 0.999).item(),
            sample.median().item(), (got - ref).abs().max().item())


def k2_precision(got, ref32, *args):
    """Where K2's disagreement with its plain version comes from, on the
    checked tiles: the kernel and the plain f32 version each against the
    plain version run in f64 (same walk), and the TF32 mirror of the
    kernels' sums (`backward_sums_tf32`: the split products and the moment
    epilogue over exact f32 sums) against the plain f32 version."""
    import torch
    from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_splat as cs
    a64 = [a.double() if isinstance(a, torch.Tensor) and a.is_floating_point()
           else a for a in args]
    ref64 = cs.splat_backward_pose_plain(*a64)
    mirror = cs.splat_backward_pose_plain(
        *args, sums=cs.backward_sums_tf32(*args))
    fmt = lambda e: f"max {e[0]:.3e} 99.9th {e[1]:.3e} median {e[2]:.3e}"
    print(f"  K2 precision (scaled as above): kernel vs plain f64 "
          f"{fmt(scaled_errors(got, ref64))}; plain f32 vs plain f64 "
          f"{fmt(scaled_errors(ref32, ref64))}; TF32 mirror vs plain f32 "
          f"{fmt(scaled_errors(mirror, ref32))}")


def check_close(name, got, ref, bulk):
    """Errors scaled per last-axis channel by that channel's max |ref|:
      - 99.9% of elements within `bulk`: f32 sums in another order, and a
        transmittance that is a product of up to mpt = 512 factors (the
        plain version's cumprod associates differently: ~n ulp, 3e-5);
      - every element within MAX_SCALED_ERR: the kernel and the plain
        version round alpha and T differently, so a pair sitting exactly at
        a threshold (alpha >= 1/255, T after >= 1e-4) can be kept by one and
        dropped by the other; one such pair moves its pixel by at most
        alpha * T (~1/255 at the alpha cut, ~1e-2 at the T cut)."""
    err, p999, _, abs_err = scaled_errors(got, ref)
    ok = err <= MAX_SCALED_ERR and p999 <= bulk
    print(f"  {name}: max abs err {abs_err:.3e}; scaled err max {err:.3e} "
          f"(tolerance {MAX_SCALED_ERR:g}), 99.9th percentile {p999:.3e} "
          f"(tolerance {bulk:g}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return abs_err


WORK_KEYS = ("walked", "blended", "slots", "steps", "steps_box", "steps_blend",
             "sub_steps", "sub_box", "sub_blend", "kept_outside_box")


def walk_counts(walked, kept, blended, box):
    """Counts of one batch of tiles from the plain walk's (T, 256, M) masks
    and the (T, M, 4) cull boxes: pairs walked and blended, slots walked;
    then per 8 x 4 pixel block (one warp of the kernels): the (block, slot)
    steps some lane walks, those the slot's box keeps, those in which some
    lane blends; the same three per (block, 16-slot sub-chunk); and the
    steps with a kept pair whose box misses the block (must be 0)."""
    import torch
    from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_splat as cs
    meets = cs.box_meets_blocks(box)                            # (T, 8, M)
    wk_b = cs.block_pixels(walked).any(2)
    bl_b = cs.block_pixels(blended).any(2)
    kept_b = cs.block_pixels(kept & walked).any(2)
    T, B, M = wk_b.shape
    sub = lambda x: torch.nn.functional.pad(x, (0, -M % 16)).view(
        T, B, -1, 16).any(3)
    vals = (walked.sum(), blended.sum(), walked.any(1).sum(), wk_b.sum(),
            (wk_b & meets).sum(), bl_b.sum(), sub(wk_b).sum(),
            sub(wk_b & meets).sum(), sub(bl_b).sum(), (kept_b & ~meets).sum())
    return [int(v) for v in vals]


def splat_work(slots8, counts, cp, tiles_x, tile_ids=None):
    """`walk_counts` of the splat kernels on these inputs, over all tiles;
    `tile_ids`: the image tile of each row (default the row)."""
    from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_splat as cs
    n = [0] * len(WORK_KEYS)
    for ids in batched(slots8.shape[0], 128):
        tid = ids if tile_ids is None else tile_ids[ids].long()
        w = cs._walk(slots8[ids], counts[ids], cp, tiles_x, tid)
        box = cs.slot_box(slots8[ids], cp, tiles_x, tid, w["q"])
        got = walk_counts(w["walked"], w["keep"], w["keep"] & w["include"],
                          box)
        n = [a + b for a, b in zip(n, got)]
    return dict(zip(WORK_KEYS, n))


def blend_work(recs, counts, tiles_x):
    """`walk_counts` of the blend kernels on these inputs, over all tiles."""
    from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_blend as cb
    n = [0] * len(WORK_KEYS)
    for ids in batched(recs.shape[0], 128):
        w = cb._blend_walk(recs[ids], counts[ids], tiles_x, ids)
        box = cb.record_box(recs[ids], tiles_x, ids)
        got = walk_counts(w["walked"], w["keep"], w["blended"], box)
        n = [a + b for a, b in zip(n, got)]
    return dict(zip(WORK_KEYS, n))


def steps_line(name, work, sub_chunks=True):
    """The block-step counts of `walk_counts` (`sub_chunks`: also per
    16-slot sub-chunk, the backwards' unit); raises on a kept pair that its
    slot's box would have culled."""
    share = lambda a, b: f"{work[a]} ({work[a] / max(work[b], 1):.4f})"
    line = (f"  {name}: (8x4 block, slot) steps walked {work['steps']}, the "
            f"box keeps {share('steps_box', 'steps')}, some lane blends "
            f"{share('steps_blend', 'steps')}")
    if sub_chunks:
        line += (f"; (block, 16-slot sub-chunk) steps walked "
                 f"{work['sub_steps']}, the boxes keep "
                 f"{share('sub_box', 'sub_steps')}, some lane blends "
                 f"{share('sub_blend', 'sub_steps')}")
    print(line)
    if work["kept_outside_box"]:
        raise AssertionError(f"{name}: {work['kept_outside_box']} (block, "
                             f"slot) steps keep a pair outside the slot's box")


def other_blend_forward(src_dir):
    """K4 as `src_dir`/blend.cu has it (another version of the source),
    built beside the repository's own library: (recs, counts, tiles_x, C)
    -> (T, 256, C)."""
    import ctypes
    import torch
    from vtgaussian_slam_tpu_torch.ops.rasterizer import _build
    tag = "".join(c if c.isalnum() else "_" for c in src_dir)
    lib_path = _build.BUILD / f"libblend_other_{tag}_{os.getpid()}.so"
    log = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
         os.path.join(src_dir, "blend.cu")], check=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True).stdout.splitlines()
    for i, line in enumerate(log):      # ptxas: the forward kernel's report
        if "Compiling" in line and "blend_fwd_kernel" in line:
            print(f"  [{src_dir}] "
                  + " | ".join(x.strip() for x in log[i + 2:i + 4]))
    fn = ctypes.CDLL(str(lib_path)).vtgs_blend_fwd
    fn.argtypes = list(_build.SIGNATURES["blend"]["vtgs_blend_fwd"])
    fn.restype = ctypes.c_int

    def run(recs, counts, tiles_x, n_channels):
        out = torch.empty((recs.shape[0], 256, n_channels),
                          dtype=torch.float32, device=recs.device)
        err = fn(recs.data_ptr(), counts.data_ptr(), None, recs.shape[0],
                 recs.shape[2], tiles_x, 0, n_channels, out.data_ptr(),
                 _build.stream_of(recs))
        if err:
            raise RuntimeError(f"{src_dir}: vtgs_blend_fwd CUDA error {err}")
        return out
    return run


def bound(name, bytes_moved, work):
    flops = (work["walked"] * FLOPS_WALKED[name]
             + work["blended"] * FLOPS_BLENDED[name]
             + work["slots"] * FLOPS_SLOT[name])
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def busy_line(tag, loop):
    """Run `loop` (BUSY_ITERS iterations of one optimisation loop) once to
    warm up, once timed by the host clock alone, and once under
    torch.profiler; print the summed device time over the unprofiled wall
    time, the device launches per iteration and the five device kernels
    with the most time, under the profiler's names."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    loop()
    torch.cuda.synchronize()
    t0 = time.time()
    loop()
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        loop()
        torch.cuda.synchronize()
        prof_wall_ms = (time.time() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            rows.append((us / 1e3, e.count, e.key))
    if not rows:
        raise AssertionError(f"[busy] {tag}: the profiler saw no device time")
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows)
    n_launch = sum(r[1] for r in rows)
    top = "; ".join(f"{key[:60]} {ms:.3f} ms x{cnt}"
                    for ms, cnt, key in rows[:5])
    print(f"[busy] {tag}: {BUSY_ITERS} iterations, wall {wall_ms:.2f} ms "
          f"({wall_ms / BUSY_ITERS:.3f} ms per iteration; under the profiler "
          f"{prof_wall_ms:.2f} ms), device time {dev_ms:.2f} ms, busy share "
          f"{dev_ms / wall_ms:.4f}, device launches per iteration "
          f"{n_launch / BUSY_ITERS:.1f} | top: {top}")


def first_difference(eng, ref, ref_params_ls, n):
    """None when the two engines' trajectories over frames 0..n-1, sections
    (live rows) and exports are equal to the bit, else (frame or section,
    quantity)."""
    import numpy as np
    for t in range(n):
        for name, a, b in (("quat", eng.traj.quats, ref.traj.quats),
                           ("trans", eng.traj.trans, ref.traj.trans)):
            if not np.array_equal(a[t].cpu().numpy(), b[t].cpu().numpy()):
                return f"frame {t}", f"pose {name}"
    if len(eng.sections) != len(ref.sections):
        return "sections", f"{len(eng.sections)} vs {len(ref.sections)}"
    got = eng.export_params_ls()
    for i, (p, q) in enumerate(zip(got, ref_params_ls)):
        for k in PARAM_KEYS:
            if p[k].shape != q[k].shape or not np.array_equal(p[k], q[k]):
                return f"section {i}", k
    return None


def resume_phase(engine3, config3, params_ls3, refs3, wrappers):
    """2f-a: phase 2c's checkpoint after frame RESUME_FROM, and one written
    with a section in pinned host memory; a fresh engine resumed through
    `run` and held to phase 2c's run."""
    import copy
    import numpy as np
    import torch
    from vtgaussian_slam_tpu_torch.core.pipeline import VTGaussianSLAM
    from vtgaussian_slam_tpu_torch.utils.checkpoint import (read_checkpoint,
                                                            save_checkpoint)
    tag = "2f-a resume"
    log = engine3.checkpoint_log
    assert [c["t"] for c in log] == [RESUME_FROM], log
    c = log[0]
    ft = engine3.frame_times[RESUME_FROM]
    _, meta = read_checkpoint(config3, c["path"])
    print(f"[{tag}] phase 2c saved frame {RESUME_FROM} in {c['save_s']:.3f} "
          f"s ({c['bytes'] / 1e6:.1f} MB, {meta['n_sections']} sections; a "
          f"probe reading in flight: {c['harm_in_flight']}); the frame's own "
          f"split track {ft['track']:.3f} s densify {ft['densify']:.3f} s map "
          f"{ft['map']:.3f} s")
    # phase 2c's paging check paged a section back in: page the cold ones
    # out again, as after the run's last frame
    engine3._page_cold_sections({(BOUNDARY_FRAMES - 1) // engine3.bfe}
                                | set(engine3.fixed_section_ids or ()))
    engine3._page_cold_finish()
    paged = [i for i in engine3.paged_sections() if i in refs3]
    assert paged, engine3.paged_sections()
    t_last = BOUNDARY_FRAMES - 1
    t0 = time.time()
    path = save_checkpoint(engine3, t_last)
    save_s = time.time() - t0
    data, _ = read_checkpoint(config3, path)
    for i in paged:
        n = engine3.sections[i].n_active
        for k, ref in zip(PARAM_KEYS[:5], refs3[i][:5]):
            assert np.array_equal(data[f"sec{i}_{k}"], ref[:n].cpu().numpy()), k
    print(f"[{tag}] a checkpoint after frame {t_last} with section(s) "
          f"{paged} in pinned host memory: {save_s:.3f} s, "
          f"{os.path.getsize(path) / 1e6:.1f} MB; the paged sections' arrays "
          f"equal to the bit to their page-out copies")

    cfg = copy.deepcopy(config3)
    cfg.update(save_checkpoints=False, load_checkpoint=True,
               checkpoint_time_idx=RESUME_FROM)
    zeroed(wrappers)
    t0 = time.time()
    eng = VTGaussianSLAM(cfg, device="cuda")
    init_s = time.time() - t0
    t0 = time.time()
    eng.run(BOUNDARY_FRAMES)
    torch.cuda.synchronize()
    run_s = time.time() - t0
    launches = read_counts(wrappers)
    load_s = eng.checkpoint_log[0]["load_s"]
    diff = first_difference(eng, engine3, params_ls3, BOUNDARY_FRAMES)
    ate = eng.ate(BOUNDARY_FRAMES)
    print(f"[{tag}] a fresh engine ({init_s:.2f} s) resumed from frame "
          f"{RESUME_FROM} through run: load {load_s:.3f} s, frames "
          f"{RESUME_FROM + 1}-{t_last} in {run_s:.2f} s, sections "
          f"{[s.n_active for s in eng.sections]}, paged "
          f"{eng.paged_sections()}, ATE {ate * 100:.4f} cm (phase 2c "
          f"{engine3.ate(BOUNDARY_FRAMES) * 100:.4f}); against phase 2c's "
          f"run: " + ("equal to the bit (trajectory, sections, export)"
                      if diff is None else f"parts first at {diff[0]}, "
                      f"{diff[1]}") + f" | launches {launches}")
    if diff is not None and not c["harm_in_flight"]:
        raise AssertionError(f"[{tag}] the resumed run parts from phase 2c "
                             f"with no probe reading in flight: {diff}")
    assert all(launches[k] > 0 for k in ("K1", "K2", "K3", "K4")), launches
    assert ate < 0.05, ate
    return launches


def progress_phase(wrappers):
    """2f-b: the room0 proxy with use_wandb on, as make_config ships it:
    events.jsonl against the iteration counts, the progress PSNR beside
    evaluate_frame's, t_progress per frame."""
    import contextlib
    import glob
    import shutil
    import torch
    from vtgaussian_slam_tpu_torch.core.pipeline import VTGaussianSLAM
    tag = "2f-b progress"
    cfg = room0_proxy_config()
    cfg["use_wandb"] = True
    cfg["workdir"] = os.path.join(F_WORKDIR, "progress")
    shutil.rmtree(cfg["workdir"], ignore_errors=True)
    zeroed(wrappers)
    tee = Tee(sys.stdout)
    eng = VTGaussianSLAM(cfg, device="cuda")
    with contextlib.redirect_stdout(tee):
        eng.run(PROGRESS_FRAMES)
    torch.cuda.synchronize()
    launches = read_counts(wrappers)
    out = tee.text()
    rdir = eng.run_dir()
    recs = [json.loads(x) for x in
            open(os.path.join(rdir, "events.jsonl")).read().splitlines()]
    n = lambda key: sum(1 for r in recs if key in r)
    counts = {"init": n("event"),
              "tracking": n("Per Iteration Tracking/Loss"),
              "mapping": n("Per Iteration Mapping/Loss"),
              "progress": n("Tracking/PSNR"),
              "final": n("Final Stats/step")}
    want = {"init": 1, "tracking": eng.stats["tracking_loop_iters"],
            "mapping": eng.stats["mapping_loop_iters"],
            "progress": PROGRESS_FRAMES - 1, "final": 1}
    print(f"[{tag}] events.jsonl records {counts}; the loops' iterations "
          f"and frames {want}")
    assert counts == want, (counts, want)
    prog = [r for r in recs if "Tracking/PSNR" in r]
    for r in prog:
        t = int(r["Tracking/step"])
        psnr, l1 = eng.evaluate_frame(t)
        print(f"[{tag} frame {t}] progress PSNR {r['Tracking/PSNR']:.2f} dB "
              f"(presence-masked at the tracking silhouette 0.999), depth "
              f"RMSE {r['Tracking/Depth RMSE'] * 100:.3f} cm, pose error "
              f"{r['Tracking/Latest Pose Error'] * 100:.3f} cm | "
              f"evaluate_frame PSNR {psnr:.2f} dB | t_progress "
              f"{eng.frame_times[t]['timers']['t_progress']:.3f} s")
    notes = out.count("no matplotlib: panels skipped")
    plots = os.path.isdir(os.path.join(rdir, "plots"))
    dumps = glob.glob(os.path.join(rdir, "params*.npz"))
    print(f"[{tag}] 'no matplotlib: panels skipped' printed {notes} time(s); "
          f"plots/ written {plots}; emergency params*.npz {len(dumps)} | "
          f"launches {launches}")
    assert not dumps and "Failed to evaluate trajectory" not in out
    assert (notes == 1 and not plots) or (notes == 0 and plots)
    assert all(launches[k] > 0 for k in ("K1", "K2", "K3", "K4")), launches
    eng.close()
    return launches


def scannetpp_config():
    from configs.common import make_config
    cfg = make_config("scannetpp", "proxy", seed=2)
    cfg["init_err_ratio"] = 0    # the rescue and the odometer every frame
    cfg["workdir"] = os.path.join(F_WORKDIR, "scannetpp")
    cfg["data"] = dict(
        dataset_name="synthetic",
        synthetic=dict(num_frames=40, height=584, width=876, seed=0,
                       motion_scale=0.05),
        sequence="proxy", desired_image_height=584, desired_image_width=876,
        densification_image_height=1168, densification_image_width=1752,
        start=0, end=-1, stride=1, num_frames=-1)
    return cfg


def scannetpp_phase(wrappers):
    """2f-c: the ScanNet++ proxy, use_wandb on, init_err_ratio 0: the probe,
    the rescue and the odometer per frame against the synthetic ground
    truth, and the odometer's time at 584x876."""
    import shutil
    import numpy as np
    import torch
    from vtgaussian_slam_tpu_torch.core.odometry import \
        rgbd_odometry_multi_scale
    from vtgaussian_slam_tpu_torch.core.pipeline import VTGaussianSLAM
    tag = "2f-c scannetpp"
    cfg = scannetpp_config()
    shutil.rmtree(cfg["workdir"], ignore_errors=True)
    zeroed(wrappers)
    t0 = time.time()
    eng = VTGaussianSLAM(cfg, device="cuda")
    assert eng.dataset_name == "scannetpp" and eng.odometer is not None
    init_s = time.time() - t0
    t0 = time.time()
    eng.run(PP_FRAMES)
    torch.cuda.synchronize()
    run_s = time.time() - t0
    launches = read_counts(wrappers)
    tr = cfg["tracking"]
    print(f"[{tag}] {eng.cam.height}x{eng.cam.width} (densification "
          f"{eng.densify_cam.height}x{eng.densify_cam.width}), {PP_FRAMES} "
          f"frames in {run_s:.2f} s (init {init_s:.2f} s), tracking "
          f"{tr['num_iters']} iterations (x2 when rescued), mapping "
          f"{cfg['mapping']['num_iters']} | launches {launches}")
    poses = [np.asarray(eng.dataset[t][3], np.float64)
             for t in range(PP_FRAMES)]
    errs = []
    for r in eng.rescue_log:
        t = r["t"]
        ft = eng.frame_times[t]
        line = (f"[{tag} frame {t}] probe im {r['probe_im']:.2f} depth "
                f"{r['probe_depth']:.2f} | rescue {r['fired']}, "
                f"{r['num_iters']} iterations")
        if r["odometer_rel"] is not None:
            rel = np.asarray(r["odometer_rel"], np.float64)
            gt = np.linalg.inv(poses[t - 1]) @ poses[t]
            t_err = float(np.linalg.norm(rel[:3, 3] - gt[:3, 3]))
            dR = rel[:3, :3].T @ gt[:3, :3]
            ang = float(np.degrees(np.arccos(np.clip(
                (np.trace(dR) - 1) / 2, -1, 1))))
            errs.append(t_err)
            line += (f" | odometer vs ground truth {t_err * 100:.3f} cm, "
                     f"{ang:.3f} deg (motion "
                     f"{np.linalg.norm(gt[:3, 3]) * 100:.3f} cm)")
        psnr, l1 = eng.evaluate_frame(t)
        line += (f" | track {ft['track']:.3f} s map {ft['map']:.3f} s | "
                 f"ATE over 0..{t} {eng.ate(t + 1) * 100:.4f} cm | PSNR "
                 f"{psnr:.2f} dB, depth L1 {l1 * 100:.3f} cm")
        print(line)
    fired = [r["t"] for r in eng.rescue_log if r["fired"]]
    ate = eng.ate(PP_FRAMES)
    assert fired == list(range(2, PP_FRAMES)), fired
    assert len(errs) == len(fired) and max(errs) < 0.05, errs
    assert ate < 0.05, ate
    assert all(launches[k] > 0 for k in ("K1", "K2", "K3", "K4")), launches

    # the odometer's own time at this size: frames 0 -> 1
    d0 = eng.odometer._depth(eng.dataset[0][1])
    g0 = eng.odometer._gray(eng.dataset[0][0])
    d1 = eng.odometer._depth(eng.dataset[1][1])
    g1 = eng.odometer._gray(eng.dataset[1][0])
    ms = event_ms(lambda: rgbd_odometry_multi_scale(
        d0, g0, d1, g1, eng.odometer.intrinsics, hybrid=False))
    ms_h = event_ms(lambda: rgbd_odometry_multi_scale(
        d0, g0, d1, g1, eng.odometer.intrinsics, hybrid=True))
    print(f"[{tag}] ATE {ate * 100:.4f} cm over {PP_FRAMES} frames (bound < 5 "
          f"cm); rescued frames {fired}; rgbd_odometry_multi_scale at "
          f"{eng.cam.height}x{eng.cam.width}: point-to-plane {ms:.2f} ms, "
          f"hybrid {ms_h:.2f} ms per call (CUDA events, median of 10)")
    # the probe's render inputs at the last frame, for phase 3's K4
    t = PP_FRAMES - 1
    sec = eng.sections[t // eng.bfe]
    probe = (sec, eng.traj.quats[t].clone(), eng.traj.trans[t].clone(),
             eng.cam, dict(eng.backend_kwargs))
    eng.close()
    return launches, probe


def masked_share(params_ls, dataset, n, bfe, bk, sil_thres=0.5):
    """The share of pixels whose silhouette is at most `sil_thres` in the
    renders of frames 0..n-1 at the budget `bk`."""
    import numpy as np
    from vtgaussian_slam_tpu_torch.eval.evaluate import \
        _load_sections_and_renderer
    from vtgaussian_slam_tpu_torch.ops.camera import setup_camera
    secs, traj, render = _load_sections_and_renderer(params_ls, bk, "cuda")
    color0, _, K, _ = dataset[0]
    cam = setup_camera(color0.shape[1], color0.shape[0], np.asarray(K)[:3, :3])
    out = []
    for t in range(n):
        s = secs[min(t // bfe, len(secs) - 1)]
        r = render(s.params, s.active_mask(), traj.quats[t], traj.trans[t],
                   cam)
        out.append(float((r.silhouette <= sil_thres).float().mean()))
    return float(np.mean(out))


def mesh_phase(engine3, params_ls3, bk_train3, bk_eval3, wrappers):
    """2f-d: eval_recon over phase 2c's export at the reference's voxel and
    truncation, at the eval_mode budget; then scored against its own mesh."""
    import shutil
    import torch
    from vtgaussian_slam_tpu_torch.eval.evaluate import eval_recon
    tag = "2f-d mesh"
    wdir = os.path.join(F_WORKDIR, "recon")
    shutil.rmtree(wdir, ignore_errors=True)
    kw = dict(eval_every=1, baseframe_every=engine3.bfe,
              voxel_length=5.0 / 512, sdf_trunc=0.04, device="cuda")
    zeroed(wrappers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = eval_recon(engine3.dataset, params_ls3, engine3.frames_done,
                     os.path.join(wdir, "mesh"), backend_kwargs=bk_eval3,
                     **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = read_counts(wrappers)
    st = out["stats"]
    share_512 = masked_share(params_ls3, engine3.dataset, engine3.frames_done,
                             engine3.bfe, bk_train3)
    print(f"[{tag}] eval_recon over {engine3.frames_done} frames at mpt "
          f"{bk_eval3['max_pairs_per_tile']}, voxel 5/512 m, sdf_trunc 0.04: "
          f"voxel dims {st['voxel_dims']}, state {st['state_bytes'] / 1e9:.3f} "
          f"GB, peak allocated {peak / 1e9:.3f} GB | render "
          f"{st['render_s']:.3f} s, integrate {st['integrate_ms_per_frame']:.2f}"
          f" ms per frame, extract {st['extract_s']:.3f} s, clean "
          f"{st['clean_s']:.3f} s, PLY write {st['write_s']:.3f} s, "
          f"{wall:.2f} s in all | n_verts {out['n_verts']}, n_faces "
          f"{out['n_faces']} | silhouette-masked pixels "
          f"{st['masked_share']:.4f} at this budget, {share_512:.4f} at mpt "
          f"{bk_train3['max_pairs_per_tile']} | launches {launches}")
    assert out["n_faces"] > 1000, out
    assert launches["K4"] == engine3.frames_done, launches
    zeroed(wrappers)
    t0 = time.time()
    scored = eval_recon(engine3.dataset, params_ls3, engine3.frames_done,
                        os.path.join(wdir, "self"), backend_kwargs=bk_eval3,
                        gt_mesh_path=out["mesh_path"], n_2d_views=20, **kw)
    torch.cuda.synchronize()
    launches2 = read_counts(wrappers)
    print(f"[{tag}] against its own mesh: accuracy "
          f"{scored['accuracy_cm']:.4f} cm, completion "
          f"{scored['completion_cm']:.4f} cm (bound < 3 cm), 2D depth L1 of 20 "
          f"views {scored['depth l1']:.4f} cm | {time.time() - t0:.2f} s | "
          f"launches {launches2}")
    assert scored["accuracy_cm"] < 3.0 and scored["completion_cm"] < 3.0
    assert scored["depth l1"] < 0.5, scored
    return {k: launches[k] + launches2[k] for k in launches}


def dense_phase(params_ls3, engine3, wrappers):
    """2f-e: `api.render` on the tiled route (K4) against `render_dense` on
    a 128x128 camera over DENSE_N Gaussians of phase 2c's last section, and
    refinement's counts on the card against the CPU's."""
    import numpy as np
    import torch
    from vtgaussian_slam_tpu_torch.core.losses import _slam_inputs
    from vtgaussian_slam_tpu_torch.models import gaussians as G
    from vtgaussian_slam_tpu_torch.models import refinement as R
    from vtgaussian_slam_tpu_torch.ops.camera import Camera
    from vtgaussian_slam_tpu_torch.ops.rasterizer import api
    from vtgaussian_slam_tpu_torch.ops.rasterizer.projection import \
        project_gaussians
    from vtgaussian_slam_tpu_torch.ops.rasterizer.tiled import tile_records
    tag = "2f-e dense"
    sec, traj = G.section_from_numpy_params(params_ls3[-1], device="cuda")
    t = BOUNDARY_FRAMES - 1
    means_cam, quats, scales, opac, colors6 = _slam_inputs(
        sec.params, traj.quats[t], traj.trans[t])
    n = sec.n_active
    c0 = engine3.cam
    s = DENSE_HW / c0.width
    cam = Camera(height=DENSE_HW, width=DENSE_HW, fx=c0.fx * s, fy=c0.fy * s,
                 cx=DENSE_HW / 2, cy=DENSE_HW / 2)
    z = means_cam[:n, 2]
    u = cam.fx * means_cam[:n, 0] / z + cam.cx
    v = cam.fy * means_cam[:n, 1] / z + cam.cy
    seen = torch.nonzero((z > 0.2) & (u >= 0) & (u < DENSE_HW) & (v >= 0)
                         & (v < DENSE_HW)).flatten()
    pick = seen[torch.randperm(len(seen), generator=torch.Generator()
                               .manual_seed(0))[:DENSE_N].to(seen.device)]
    # rgb, depth and silhouette: the depth and silhouette channels do not
    # depend on the order of Gaussians whose depths tie in the binning's
    # 21-bit log-depth key (the tiled route blends those in slot order,
    # the dense one in depth order), the rgb channels do
    colors = colors6[:, :5]
    args = [x[pick].contiguous() for x in (means_cam, quats, scales, opac,
                                           colors)]
    mpt = 16384
    _, counts, _ = tile_records(*args, cam, span_cap=3,
                                max_pairs_per_tile=mpt)
    zeroed(wrappers)
    with torch.no_grad():
        tiled = api.render(*args, cam, backend="tiled", span_cap=3,
                           max_pairs_per_tile=mpt)
        dense = api.render(*args, cam, backend="dense")
    torch.cuda.synchronize()
    launches = read_counts(wrappers)
    diff = (tiled.image - dense.image).abs()
    err_ds = float(diff[3:].max())
    err_rgb = float(diff[:3].max())
    share_rgb = float((diff[:3].amax(0) > 2e-4).float().mean())
    same_radii = torch.equal(tiled.radii, dense.radii)
    print(f"[{tag}] {len(pick)} Gaussians of phase 2c's section "
          f"{len(params_ls3) - 1} ({len(seen)} in view) at frame {t}'s pose, "
          f"{DENSE_HW}x{DENSE_HW}: api.render tiled (K4, mpt {mpt}, fullest "
          f"tile {int(counts.max())} pairs) against render_dense: depth and "
          f"silhouette max |diff| {err_ds:.2e} (bound 2e-4, tests/"
          f"test_rasterizer.py's), radii equal {same_radii}; rgb max |diff| "
          f"{err_rgb:.2e}, {share_rgb:.4f} of pixels above 2e-4 (depth ties "
          f"blended in another order) | launches {launches}")
    assert int(counts.max()) < mpt and err_ds <= 2e-4 and same_radii
    # the same Gaussians moved along their rays (x, y, z scaled alike, so
    # the screen positions stay), log-depth raised by 2e-5 per depth rank,
    # 2.6 steps of the key's 16.1181 / 2^21: no two keys tie, and every
    # channel agrees
    rank = torch.argsort(torch.argsort(args[0][:, 2])).float()
    spread = [args[0] * torch.exp(2e-5 * rank)[:, None]] + args[1:]
    with torch.no_grad():
        a = api.render(*spread, cam, span_cap=3, max_pairs_per_tile=mpt)
        b = api.render(*spread, cam, backend="dense")
    err_spread = float((a.image - b.image).abs().max())
    print(f"[{tag}] the same Gaussians with their depths spread apart (no "
          f"ties in the key): tiled against dense max |diff| "
          f"{err_spread:.2e} over rgb, depth and silhouette (bound 2e-4)")
    assert err_spread <= 2e-4
    assert launches["K4"] == 1, launches
    # tests/test_rasterizer.py's random scenes (depths spread over 1-4 m),
    # every channel
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        n = 200
        zz = rng.uniform(1.0, 4.0, n)
        uu = rng.uniform(4.0, DENSE_HW - 4.0, n)
        vv = rng.uniform(4.0, DENSE_HW - 4.0, n)
        scene = [np.stack([(uu - cam.cx) / cam.fx * zz,
                           (vv - cam.cy) / cam.fy * zz, zz], -1),
                 rng.normal(size=(n, 4)),
                 np.exp(rng.uniform(-3.5, -2.5, (n, 3))),
                 1 / (1 + np.exp(-rng.normal(size=n))),
                 rng.uniform(0, 1, (n, 3))]
        scene = [torch.as_tensor(x, dtype=torch.float32, device="cuda")
                 for x in scene]
        # tiles enough for the widest footprint: the binning cuts a
        # Gaussian's rect at span_cap tiles a side
        rmax = float(project_gaussians(*scene[:4], cam).radius.max())
        span = int(np.ceil((2 * rmax + 2) / 16)) + 1
        with torch.no_grad():
            a = api.render(*scene, cam, max_pairs_per_tile=1024,
                           span_cap=span)
            b = api.render(*scene, cam, backend="dense")
        e = float((a.image - b.image).abs().max())
        print(f"[{tag}] random scene seed {seed} ({n} anisotropic Gaussians, "
              f"1-4 m, span_cap {span}): tiled against dense max |diff| "
              f"{e:.2e} over rgb "
              f"(bound 2e-4), radii equal {torch.equal(a.radii, b.radii)}")
        assert e <= 2e-4 and torch.equal(a.radii, b.radii)

    # refinement on that subset, on the card and on the CPU
    sub = {k: params_ls3[-1][k][pick.cpu().numpy()] for k in PARAM_KEYS[:5]}
    sub.update(cam_unnorm_rots=params_ls3[-1]["cam_unnorm_rots"],
               cam_trans=params_ls3[-1]["cam_trans"])
    rng = np.random.default_rng(0)
    accum = rng.uniform(0, 0.4, len(pick)).astype(np.float32)
    # prune below the subset's median opacity: about half goes
    op_med = float(np.median(1 / (1 + np.exp(-sub["logit_opacities"]))))
    prune = dict(start_after=0, remove_big_after=0, stop_after=20,
                 prune_every=20, removal_opacity_threshold=op_med,
                 final_removal_opacity_threshold=op_med,
                 reset_opacities=False, reset_opacities_every=500)
    dens = dict(start_after=0, remove_big_after=10000, stop_after=5000,
                densify_every=1, grad_thresh=0.3, num_to_split_into=2,
                removal_opacity_threshold=0.005,
                final_removal_opacity_threshold=0.005,
                reset_opacities_every=3000)
    got = {}
    for dev in ("cpu", "cuda"):
        s_, _ = G.section_from_numpy_params(sub, device=dev)
        s_.vars.scene_radius = sec.vars.scene_radius
        cap = s_.capacity
        a = torch.zeros(cap, device=dev)
        a[:len(pick)] = torch.as_tensor(accum, device=dev)
        s_ = s_.replace(vars=G.GaussianVars(
            s_.vars.max_2d_radius, a, (a > 0).float(), s_.vars.timestep,
            s_.vars.scene_radius))
        noise = torch.randn((2, cap, 3), generator=torch.Generator()
                            .manual_seed(1))
        pruned, _ = R.prune_gaussians(s_, None, 20, prune)
        grown, _ = R.densify_split_clone(s_, None, 1, dens, noise=noise)
        got[dev] = (pruned.n_active, grown.n_active,
                    grown.params.means3d[:grown.n_active].cpu())
    (pc, gc, mc), (pg, gg, mg) = got["cpu"], got["cuda"]
    print(f"[{tag}] refinement of those {len(pick)}: prune_gaussians keeps "
          f"{pg} on the card, {pc} on the CPU; densify_split_clone gives "
          f"{gg} / {gc}; means within {float((mg - mc).abs().max()):.1e}")
    assert (pg, gg) == (pc, gc) and pc < len(pick) < gc
    assert float((mg - mc).abs().max()) <= 1e-5
    return launches


def phase_2f(engine3, config3, params_ls3, refs3, bk_train3, bk_eval3,
             wrappers):
    """Phase 2f; each sub-phase's launches are counted from zero and
    returned for the kernels line."""
    import torch
    t0 = time.time()
    launches = {"resume": resume_phase(engine3, config3, params_ls3, refs3,
                                       wrappers),
                "progress": progress_phase(wrappers)}
    launches["scannetpp"], probe = scannetpp_phase(wrappers)
    launches["mesh"] = mesh_phase(engine3, params_ls3, bk_train3, bk_eval3,
                                  wrappers)
    launches["dense"] = dense_phase(params_ls3, engine3, wrappers)
    torch.cuda.synchronize()
    print(f"[2f] {time.time() - t0:.1f} s; launches {launches}")
    return {"launches": launches, "probe": probe}


def loss_cotangent(accum, frame, cam, lcfg, tracking, radii=None):
    """The tracking (silhouette threshold 0.99, first iteration) or mapping
    loss's cotangent of a (T, 8, 256) accum, as the loops take it."""
    import torch
    from vtgaussian_slam_tpu_torch.core.losses import (RenderResult,
                                                       loss_from_render)
    from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_splat as cs
    acc_v = accum.detach().requires_grad_(True)
    img = cs.assemble_image(acc_v, cam)
    r = RenderResult(im=img[:3], depth=img[3:4], silhouette=img[4],
                     depth_sq=img[5:6],
                     radii=img.new_zeros((1,)) if radii is None else radii)
    out = loss_from_render(r, frame, lcfg, 0.99 if tracking else 0.5,
                           tracking)
    (g,) = torch.autograd.grad(out.loss, (acc_v,))
    return g.contiguous()


def splat_inputs(tag, slots, counts, R9, trans, cam, tiles_x, accum, g,
                 launches, tile_ids=None, tile_offset=0):
    """Phase 3's entries of K1, K2 and K3 for one input whose rows render
    the image tiles `tile_ids` (or row + `tile_offset`): the kernel with
    those operands, its plain version on the picked rows, the bytes and the
    walk's work (counted once); `launches`: the phase's launch counts."""
    import torch
    from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_splat as cs
    T, _, M = slots.shape
    cp = cs.cp_vector(R9, trans, cam)
    img = (tile_ids.long() if tile_ids is not None
           else torch.arange(T, device=slots.device) + tile_offset)
    kw = dict(tile_ids=tile_ids, tile_offset=tile_offset)
    work = {}

    def get_work():
        if not work:
            work.update(splat_work(slots, counts, cp, tiles_x, img))
        return work

    args = (slots, R9, trans, counts, accum, g, cam, tiles_x)
    plain_args = lambda ids: (slots[ids], counts[ids], cp, tiles_x,
                              accum[ids], g[ids], img[ids])
    common = dict(tag=tag, counts=counts, work=get_work)
    return {
        "K1": dict(common, launches=launches["K1"],
                   kernel=lambda: cs.splat_forward(*args[:4], cam, tiles_x,
                                                   **kw),
                   plain=lambda ids: cs.splat_forward_plain(
                       slots[ids], counts[ids], cp, tiles_x, img[ids]),
                   bytes=lambda s: s * 8 * 4 + 2 * T * 4 + T * 8 * 256 * 4),
        "K2": dict(common, launches=launches["K2"],
                   kernel=lambda: cs.splat_backward_pose(*args, **kw),
                   plain=lambda ids: cs.splat_backward_pose_plain(
                       *plain_args(ids)),
                   bytes=lambda s: (s * 8 * 4 + 2 * T * 4
                                    + 2 * T * 8 * 256 * 4 + T * 12 * 4)),
        "K3": dict(common, launches=launches["K3"],
                   kernel=lambda: cs.splat_backward_vals_rows(*args, **kw),
                   plain=lambda ids: cs.splat_backward_vals_rows_plain(
                       *plain_args(ids)),
                   bytes=lambda s: (s * 8 * 4 + 2 * T * 4
                                    + 2 * T * 8 * 256 * 4 + T * M * 8 * 4))}


def tile_subset_inputs(tag, slots, counts, R9, trans, cam, tiles_x, g):
    """`splat_inputs` for rows that hold a subset of the image's tiles, as
    the tile-id operand takes them: half of the tiles of `slots` in a
    shuffled order, then 8 rows of count 0 at tile 0, with the cotangent
    rows of their tiles. No engine path passes tile ids: launches 0."""
    import torch
    from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_splat as cs
    n_tiles = counts.shape[0]
    perm = torch.randperm(n_tiles, generator=torch.Generator().manual_seed(0))
    ids = torch.cat([perm[:n_tiles // 2], torch.zeros(8, dtype=torch.long)]
                    ).to(slots.device)
    sub_counts = counts[ids].clone()
    sub_counts[-8:] = 0
    tids = ids.to(torch.int32)
    sub = slots[ids].contiguous()
    acc = cs.splat_forward(sub, R9, trans, sub_counts, cam, tiles_x, tids)
    return splat_inputs(
        f"{tag}: {n_tiles // 2} of its {n_tiles} tiles shuffled and 8 rows "
        f"of count 0, tile ids", sub, sub_counts, R9, trans, cam, tiles_x,
        acc, g[ids].contiguous(), dict.fromkeys(("K1", "K2", "K3"), 0),
        tile_ids=tids)


def shard_inputs(eng, launches, cam, tiles_x):
    """Rank 1's tile shard of the last frame of phase 2h's one-card run, as
    the sharded loops hand it to the kernels: the tracking cache and the
    frame's mapping cache padded to tile_pad_for(SHARDED_RANKS) rows, rows
    [lo, Tp) at tile_offset lo, with the loss cotangents' rows; returns
    (tracking entries, mapping entries) of `splat_inputs`."""
    from vtgaussian_slam_tpu_torch.core.map_cache import (build_kf_cache,
                                                          pack_fields8)
    from vtgaussian_slam_tpu_torch.core.track_cache import build_track_cache
    from vtgaussian_slam_tpu_torch.ops import geometry as geo
    from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_splat as cs
    from vtgaussian_slam_tpu_torch.ops.rasterizer.binning import \
        gather_channels
    from vtgaussian_slam_tpu_torch.parallel.engine import tile_pad_for
    t = SHARDED_FRAMES - 1
    sec = eng._resident(eng.section_ids[t])
    active = sec.active_mask()
    q, tr = eng.traj.quats[t].clone(), eng.traj.trans[t].clone()
    R9 = geo.quat_to_rotmat(geo.normalize(q)).reshape(9)
    bk, pad = eng.backend_kwargs, tile_pad_for(SHARDED_RANKS)
    frame = eng._stage(*eng.dataset[t][:2])
    tc = build_track_cache(sec.params, active, q, tr, cam,
                           span_cap=bk["span_cap"],
                           max_pairs_per_tile=bk["max_pairs_per_tile"],
                           chunk=bk["chunk"], tile_pad=pad,
                           select=eng._bin_select)
    kc = build_kf_cache(sec.params, active, q, tr, cam,
                        span_cap=bk["span_cap"],
                        max_pairs_per_tile=bk["max_pairs_per_tile"],
                        tile_pad=pad,
                        select=eng._bin_select)
    out = []
    for slots, counts, lcfg, tracking in (
            (tc.slots8, tc.counts, eng._loss_cfg(True), True),
            (gather_channels(pack_fields8(sec.params), kc.tab), kc.counts,
             eng._loss_cfg(False), False)):
        full = cs.splat_forward(slots, R9, tr, counts, cam, tiles_x)
        g = loss_cotangent(full, frame, cam, lcfg, tracking)
        lo = slots.shape[0] // SHARDED_RANKS * (SHARDED_RANKS - 1)
        acc = cs.splat_forward(slots[lo:], R9, tr, counts[lo:], cam, tiles_x,
                               tile_offset=lo)
        out.append(splat_inputs(
            f"rank {SHARDED_RANKS - 1}'s tile shard, rows {lo}-"
            f"{slots.shape[0] - 1} at tile_offset {lo} (phase 2h "
            f"{'tracking' if tracking else 'mapping'} cache)", slots[lo:],
            counts[lo:], R9, tr, cam, tiles_x, acc, g[lo:].contiguous(),
            launches, tile_offset=lo))
    return out


def sharded_config(mesh_devices):
    """The room0 proxy at full width, baseframe_every SHARDED_BFE, on
    `mesh_devices` ranks."""
    config = room0_proxy_config()
    config["baseframe_every"] = SHARDED_BFE
    config["tracking"]["base1_num_iters"] = TRACK_ITERS
    config["mapping"]["num_iters"] = MAP_ITERS
    config["tpu"]["mesh_devices"] = mesh_devices
    return config


def host_ms(fn, iters: int = 10) -> float:
    """Wall milliseconds per call of fn, the card synchronised around the
    calls (a collective's time includes its copies through the host)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.time() - t0) / iters * 1e3


def shard_check(eng):
    """On a rank's final state: the sharded tracking render and its pose
    gradient, and the sharded keyframe render (the newest mapping cache)
    and its field gradient, against the one-card ones computed in the same
    process: whether the renders are equal to the bit, the losses'
    difference and the gradients' largest difference over their largest
    entry."""
    import torch
    from vtgaussian_slam_tpu_torch.core.losses import loss_from_render
    from vtgaussian_slam_tpu_torch.core.map_cache import (accum_to_result,
                                                          pack_fields8,
                                                          splat_binned)
    from vtgaussian_slam_tpu_torch.core.track_cache import (build_track_cache,
                                                            render_cached)
    from vtgaussian_slam_tpu_torch.parallel import engine as pe
    t = SHARDED_FRAMES - 1
    cam, group, bk = eng.cam, eng.group, eng.backend_kwargs
    sec = eng._resident(eng.section_ids[t])
    q, tr = eng.traj.quats[t].clone(), eng.traj.trans[t].clone()
    tc = build_track_cache(sec.params, sec.active_mask(), q, tr, cam,
                           span_cap=bk["span_cap"],
                           max_pairs_per_tile=bk["max_pairs_per_tile"],
                           chunk=bk["chunk"], tile_pad=eng.tile_pad,
                           select=eng._bin_select)
    frame = eng._stage(*eng.dataset[t][:2])
    outs = []
    for render in (lambda a, b: pe.render_cached_sharded(tc, a, b, cam, group),
                   lambda a, b: render_cached(tc, a, b, cam)):
        qv = q.detach().clone().requires_grad_(True)
        tv = tr.detach().clone().requires_grad_(True)
        r = render(qv, tv)
        out = loss_from_render(r, frame, eng._loss_cfg(True), 0.99, True)
        g = torch.cat(torch.autograd.grad(out.loss, (qv, tv)))
        outs.append((r.im.detach(), out.loss.detach(), g))
    res = {"track_render_equal": torch.equal(outs[0][0], outs[1][0]),
           "track_loss_diff": float((outs[0][1] - outs[1][1]).abs()),
           "track_grad_err": float((outs[0][2] - outs[1][2]).abs().max()
                                   / outs[1][2].abs().max())}
    msec = eng.sections[t // eng.bfe]
    kfc = eng.map_store.slots[-1]
    ring = eng.map_store.ring_of_slot[-1]
    kframe = type(frame)(color=eng.ring_colors[ring],
                         depth=eng.ring_depths[ring])
    f8 = pack_fields8(msec.params)
    outs = []
    for render in (lambda v: pe.splat_binned_sharded(
            v, kfc.tab, kfc.inv, kfc.quat, kfc.trans, kfc.counts, cam, group),
                   lambda v: splat_binned(v, kfc.tab, kfc.inv, kfc.quat,
                                          kfc.trans, kfc.counts, cam)):
        v8 = f8.detach().clone().requires_grad_(True)
        r = accum_to_result(render(v8), cam)
        out = loss_from_render(r, kframe, eng._loss_cfg(False), 0.5, False)
        (g,) = torch.autograd.grad(out.loss, (v8,))
        outs.append((r.im.detach(), out.loss.detach(), g))
    res.update(
        map_render_equal=torch.equal(outs[0][0], outs[1][0]),
        map_loss_diff=float((outs[0][1] - outs[1][1]).abs()),
        map_grad_err=float((outs[0][2] - outs[1][2]).abs().max()
                           / outs[1][2].abs().max()))
    return res


def order_sensitivity(ref):
    """Per-frame largest translation difference between the one-card run
    `ref` of phase 2h's frames and the same run with every field
    gradient's inverse-map columns added in the opposite order."""
    import numpy as np
    import torch
    from vtgaussian_slam_tpu_torch.core import map_cache
    from vtgaussian_slam_tpu_torch.core.pipeline import VTGaussianSLAM
    apply = map_cache.slot_inverse_sum
    map_cache.slot_inverse_sum = lambda flat, pos, w: apply(
        flat, pos.flip(1).contiguous(), w.flip(1).contiguous())
    try:
        eng = VTGaussianSLAM(sharded_config(1), device="cuda")
        for t in range(SHARDED_FRAMES):
            eng.process_frame(t)
        torch.cuda.synchronize()
    finally:
        map_cache.slot_inverse_sum = apply
    n = SHARDED_FRAMES
    return np.abs(eng.traj.trans[:n].cpu().numpy()
                  - ref.traj.trans[:n].cpu().numpy()).max(1)


def sharded_rank(rank, world, port, out_dir):
    """One rank of phase 2h (a spawned process): join the gloo group on
    cuda:0, run SHARDED_FRAMES frames of the sharded engine with the kernel
    counts zeroed, time the loops' collectives at their shapes, and save
    the trajectory, the export, the frame split and the counts."""
    import numpy as np
    import torch
    sys.path.insert(0, REPO)
    from vtgaussian_slam_tpu_torch.core.pipeline import VTGaussianSLAM
    from vtgaussian_slam_tpu_torch.ops import map_loss as ml
    from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_blend as cb
    from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_slots as csl
    from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_splat as cs
    from vtgaussian_slam_tpu_torch.parallel import engine as pe
    pe.init_process_group(rank, world, "cuda:0", "gloo",
                          f"tcp://localhost:{port}", timeout_s=300)
    try:
        wrappers = {"K1": cs.splat_forward, "K2": cs.splat_backward_pose,
                    "K3": cs.splat_backward_vals_rows, "K4": cb.blend_forward,
                    "K5": cb.blend_backward, "K6": cs.splat_backward_all,
                    "ML": ml.map_loss_forward, "ML_bwd": ml.map_loss_backward,
                    "SG": csl.slot_gather, "SI": csl.slot_inverse_sum}
        eng = VTGaussianSLAM(sharded_config(world), device="cuda:0")
        zeroed(wrappers)
        t0 = time.time()
        for t in range(SHARDED_FRAMES):
            eng.process_frame(t)
        eng._page_cold_finish()
        torch.cuda.synchronize()
        run_s = time.time() - t0
        launches = read_counts(wrappers)
        group = eng.group
        n_tiles = (-(-eng.cam.height // 16)) * (-(-eng.cam.width // 16))
        Tp = -(-n_tiles // eng.tile_pad) * eng.tile_pad
        Tl = Tp // world
        mpt = eng.map_store.slots[-1].tab.shape[1]
        z = lambda *shape: torch.zeros(shape, device=eng.device)
        ms = {k: host_ms(lambda x=x: pe.all_gather_rows(x, group))
              for k, x in (("accum", z(Tl, 8, 256)), ("pose", z(Tl, 12)),
                           ("rows", z(Tl, mpt, 8)))}
        check = shard_check(eng)
        out = dict(quats=eng.traj.quats[:SHARDED_FRAMES].cpu().numpy(),
                   trans=eng.traj.trans[:SHARDED_FRAMES].cpu().numpy(),
                   run_s=np.array(run_s), mpt=np.array(mpt), tp=np.array(Tp),
                   frame_times=np.array(json.dumps(
                       [eng.frame_times[t] for t in range(SHARDED_FRAMES)])),
                   launches=np.array(json.dumps(launches)),
                   ms=np.array(json.dumps(ms)),
                   check=np.array(json.dumps(check)),
                   n_active=np.array([s.n_active for s in eng.sections]),
                   fixed=np.array(eng.fixed_section_ids))
        for i, sec in enumerate(eng.export_params_ls()):
            for k, v in sec.items():
                out[f"sec{i}_{k}"] = v
        eng.close()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


def sharded_phase(wrappers):
    """2h: SHARDED_RANKS ranks of the tile-sharded engine sharing the one
    card over gloo (two processes on one card: their times are not a
    multi-GPU speed), the room0 proxy for SHARDED_FRAMES frames across a
    boundary; the ranks' trajectories and exports equal to the bit, the
    trajectory within 1e-3 m of a one-card run of the same frames.
    Returns the ranks' summed launches and the one-card engine."""
    import shutil
    import socket
    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from vtgaussian_slam_tpu_torch.core.pipeline import VTGaussianSLAM
    tag = "sharded"
    shutil.rmtree(SHARDED_WORKDIR, ignore_errors=True)
    os.makedirs(SHARDED_WORKDIR)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    t0 = time.time()
    ctx = mp.start_processes(sharded_rank, args=(SHARDED_RANKS, port,
                                                 SHARDED_WORKDIR),
                             nprocs=SHARDED_RANKS, join=False,
                             start_method="spawn")
    deadline = time.time() + SHARDED_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.time())):
            if time.time() > deadline:
                raise TimeoutError(f"[{tag}] the ranks did not finish "
                                   f"within {SHARDED_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    wall = time.time() - t0
    ranks = [dict(np.load(os.path.join(SHARDED_WORKDIR, f"rank{r}.npz")))
             for r in range(SHARDED_RANKS)]
    r0 = ranks[0]
    print(f"[{tag}] {SHARDED_RANKS} ranks on one card over gloo (two "
          f"processes sharing one H100: these times are not a multi-GPU "
          f"speed): {SHARDED_FRAMES} frames in {float(r0['run_s']):.2f} s "
          f"of rank 0's clock ({wall:.1f} s with the processes' start), "
          f"baseframe_every {SHARDED_BFE}, tables padded to {int(r0['tp'])} "
          f"rows, fixed_section_ids {tuple(r0['fixed'].tolist())}, n_active "
          f"{r0['n_active'].tolist()}")
    for t, ft in enumerate(json.loads(str(r0["frame_times"]))):
        print(f"[{tag} frame {t}] track {ft['track']:.3f} s spawn "
              f"{ft['spawn']:.3f} s densify {ft['densify']:.3f} s map "
              f"{ft['map']:.3f} s")
    ms = json.loads(str(r0["ms"]))
    tl = int(r0["tp"]) // SHARDED_RANKS
    print(f"[{tag}] all-gathers (rank 0's clock, the card synchronised; "
          f"gloo copies through the host), ms per call: a rank's accum rows "
          f"({tl}, 8, 256) {ms['accum']:.3f}, its K2 pose partials ({tl}, "
          f"12) {ms['pose']:.3f}, its K3 rows ({tl}, {int(r0['mpt'])}, 8) "
          f"{ms['rows']:.3f}; per iteration: tracking "
          f"{ms['accum'] + ms['pose']:.3f} ms (one of each), mapping "
          f"{ms['accum'] + ms['rows']:.3f} ms (twice that on an iteration "
          f"with the global term's gradient)")
    ck = json.loads(str(r0["check"]))
    print(f"[{tag}] rank 0's final state, sharded against one card in the "
          f"same process: tracking render equal to the bit "
          f"{ck['track_render_equal']}, loss difference "
          f"{ck['track_loss_diff']:.3e}, pose gradient largest difference "
          f"{ck['track_grad_err']:.3e} of its largest entry; keyframe render "
          f"equal to the bit {ck['map_render_equal']}, loss difference "
          f"{ck['map_loss_diff']:.3e}, field gradient "
          f"{ck['map_grad_err']:.3e}")
    keys = sorted(r0)
    unequal = [k for k in keys if k not in ("run_s", "frame_times", "ms")
               and not np.array_equal(r0[k], ranks[1][k])]
    print(f"[{tag}] ranks' trajectories, exports and counts equal to the "
          f"bit: {not unequal} {unequal or ''}")
    if unequal:
        raise AssertionError(f"[{tag}] the ranks parted: {unequal}")
    eng1 = VTGaussianSLAM(sharded_config(1), device="cuda")
    for t in range(SHARDED_FRAMES):
        eng1.process_frame(t)
    torch.cuda.synchronize()
    d = np.abs(r0["trans"] - eng1.traj.trans[:SHARDED_FRAMES].cpu().numpy())
    dq = np.abs(r0["quats"] - eng1.traj.quats[:SHARDED_FRAMES].cpu().numpy())
    print(f"[{tag}] trajectory against a one-card run of the same frames: "
          f"max translation difference {d.max():.3e} m (bound 1e-3; per frame "
          f"{[f'{x:.2e}' for x in d.max(1)]}), max quaternion difference "
          f"{dq.max():.3e}, equal to the bit {d.max() == 0 and dq.max() == 0}"
          f"; one-card n_active {[s.n_active for s in eng1.sections]}")
    if not d.max() <= 1e-3:
        raise AssertionError(f"[{tag}] the sharded trajectory parts from the "
                             f"one-card run by {d.max():.3e} m")
    # why the sharded backwards gather rows rather than sum partials: the
    # one-card run with the field gradient's inverse-map columns added in
    # the opposite order (the kind of rounding change partial sums make)
    d_rev = order_sensitivity(eng1)
    print(f"[{tag}] the one-card run with the field gradient's inverse-map "
          f"columns added in the opposite order parts from it by "
          f"{[f'{x:.2e}' for x in d_rev]} m per frame: the mapping loop "
          f"turns rounding into trajectory, so the sharded backwards keep "
          f"the one-card summation order")
    launches = {k: 0 for k in wrappers}
    for r in ranks:
        for k, v in json.loads(str(r["launches"])).items():
            launches[k] += v
    print(f"[{tag}] launches (both ranks) {launches}")
    missing = [k for k in ("K1", "K2", "K3", "K4", "ML", "ML_bwd", "SG", "SI")
               if launches[k] <= 0]
    assert not missing, f"kernels never launched on the sharded path: {missing}"
    return dict(launches=launches, engine=eng1)


def map_loss_row(r, frame, lcfg, launches, launches1):
    """The mapping-loss kernels (csrc/maploss.cu: forward tiles, the
    fixed-order reduction, the backward scale) on phase 3's mapping inputs
    (the newest keyframe cache's render and its keyframe, 680x1200): loss,
    im_loss, depth_loss, d im and d depth from the wrappers and from the
    plain mapping branch of `loss_from_render` (its PyTorch ops, the
    kernel's dispatch off), each held to the branch's f64 values within
    the f32 rounding bound of tests/test_torch_map_loss.py; two launches
    repeat bit for bit; then the time of forward + backward (CUDA events,
    one call, median of 10; 20 back to back), the forward alone, the
    plain branch's, and the bound. Returns the `kernels` row "ML"."""
    import torch
    from unittest import mock
    from vtgaussian_slam_tpu_torch.core import losses
    from vtgaussian_slam_tpu_torch.ops import map_loss as ml
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_torch_map_loss as tml
    assert losses.fused_mapping_loss(lcfg, r.im.device)
    im = r.im.detach().requires_grad_(True)       # the strided plane views
    d = r.depth.detach().requires_grad_(True)
    rv = r._replace(im=im, depth=d)
    w = (lcfg.im_weight, lcfg.depth_weight)

    def kernel():
        loss, il, dl = ml.map_loss(im, d, r.depth_sq, frame.color,
                                   frame.depth, *w)
        return (loss, il, dl, *torch.autograd.grad(loss, (im, d)))

    def plain():
        with mock.patch.object(losses, "fused_mapping_loss",
                               lambda *a, **k: False):
            out = losses.loss_from_render(rv, frame, lcfg, 0.5, False)
        return (out.loss, out.im_loss, out.depth_loss,
                *torch.autograd.grad(out.loss, (im, d)))

    got, ref = kernel(), plain()
    share_k = tml.within_rounding(got, rv, frame, "ML kernel", lcfg)
    share_p = tml.within_rounding(ref, rv, frame, "ML plain", lcfg)
    err = max(float((a.detach() - b.detach()).abs().max())
              for a, b in zip(got, ref))
    same = all(torch.equal(a, b) for a, b in zip(got, kernel()))
    v = [float(x.detach()) for x in (*got[:3], *ref[:3])]
    print(f"[ML] mapping loss vs the plain branch at {tuple(im.shape)}: "
          f"loss {v[0]:.8f} / {v[3]:.8f}, im_loss {v[1]:.8f} / {v[4]:.8f}, "
          f"depth_loss {v[2]:.8f} / {v[5]:.8f}; max abs difference "
          f"{err:.3e}; share of the f32 rounding bound: kernel "
          f"{share_k:.4f}, plain {share_p:.4f} (ok at most 1)")
    print(f"  ML: a repeated launch gives the same bits: {same}")
    if not same:
        raise AssertionError("ML is not deterministic")
    ms = event_ms(kernel)
    b2b_ms = event_ms(kernel, per=20)
    fwd_ms = event_ms(lambda: ml.map_loss_forward(
        im, d, r.depth_sq, frame.color, frame.depth, *w, True))
    plain_ms = event_ms(plain)
    # floats a pixel: forward 9 planes read (im, gt, depth, depth_sq, gt
    # depth) and 4 written (the gradient numerators), the backward 4 read
    # and 4 written; operations a pixel and channel: 8 separable blurs of
    # 11 + 11 taps (a fused multiply-add each) and ~40 more
    _, H, W = im.shape
    bytes_moved = (9 + 4 + 4 + 4) * 4 * H * W
    flops = (8 * 22 * 2 + 40) * 3 * H * W
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    b_ms, b_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                  else (t_ops, "operations"))
    print(f"  ML: forward + backward {ms:.4f} ms (one call through the "
          f"wrappers and autograd, median; 20 calls back to back {b2b_ms:.4f}"
          f" ms per call), forward alone {fwd_ms:.4f} ms | plain "
          f"{plain_ms:.4f} ms | bound {b_ms:.4f} ms ({b_by}; "
          f"{bytes_moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) | "
          f"launches on the engine paths "
          f"{launches['ML']} forward, {launches['ML_bwd']} backward (slice "
          f"{launches1['ML']} / {launches1['ML_bwd']})")
    return {"name": "ML", "route": "cuda",
            "source": "vtgaussian_slam_tpu_torch/csrc/maploss.cu",
            "replaces": None, "launches": launches["ML"],
            "launches_bwd": launches["ML_bwd"], "max_abs_err": err,
            "ms": ms, "forward_ms": fwd_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def slot_rows(f8, kfc, rows, launches, launches1):
    """The binned mapping renderer's row movement (csrc/slots.cu) on phase
    3's mapping inputs: SG gathers the newest keyframe cache's planes from
    the section's field table, SI maps K3's rows on that cache back onto
    it. Each against its plain version bit for bit (SG's in-count slots
    also against `gather_channels`), a repeated launch equal to the bit,
    the time of one call and of 20 back to back (CUDA events, median of
    10), the PyTorch composition it replaced (the "plain" column:
    `gather_channels`, `weighted_inverse`) and the bound by bytes. Returns
    the `kernels` rows "SG" and "SI"."""
    import torch
    from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_slots as csl
    from vtgaussian_slam_tpu_torch.ops.rasterizer.binning import (
        gather_channels, weighted_inverse)
    tab, counts, pos, w = kfc.tab, kfc.counts, kfc.inv.pos, kfc.inv.w
    T, mpt = tab.shape
    N, s2 = pos.shape
    live = int(counts.sum())
    # SG: the count, a table entry and a 32-byte row per live slot read,
    # every slot's 32 bytes written; SI: positions and weights read, a
    # row per live column, a row written per Gaussian
    sg_bytes = 4 * T + live * (8 + 32) + T * mpt * 32
    si_bytes = N * s2 * (8 + 4) + int((w != 0).sum()) * 32 + N * 32
    out = []
    for name, kernel, plain, old, n_bytes in (
            ("SG", lambda: csl.slot_gather(f8, tab, counts),
             lambda: csl.slot_gather_plain(f8, tab, counts),
             lambda: gather_channels(f8, tab), sg_bytes),
            ("SI", lambda: csl.slot_inverse_sum(rows, pos, w),
             lambda: weighted_inverse(rows, pos, w),
             lambda: weighted_inverse(rows, pos, w), si_bytes)):
        got, ref = kernel(), plain()
        same_plain = torch.equal(got.view(torch.int32), ref.view(torch.int32))
        same = torch.equal(got.view(torch.int32),
                           kernel().view(torch.int32))
        if name == "SG":
            in_count = (torch.arange(mpt, device=tab.device)[None, :]
                        < counts[:, None])
            same_plain = same_plain and torch.equal(
                got.transpose(1, 2)[in_count].view(torch.int32),
                old().transpose(1, 2)[in_count].view(torch.int32))
        print(f"[{name}] {tuple(got.shape)} from {T} tiles at mpt {mpt} "
              f"({live} live slots), N {N}, s2 {s2}: equal to its plain "
              f"version to the bit: {same_plain}; a repeated launch gives "
              f"the same bits: {same}")
        if not (same_plain and same):
            raise AssertionError(f"{name} parts from its plain version or "
                                 f"from itself")
        ms = event_ms(kernel)
        b2b_ms = event_ms(kernel, per=20)
        old_ms = event_ms(old)
        b_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
        print(f"  {name}: {ms:.4f} ms (one wrapper call, median; 20 calls "
              f"back to back {b2b_ms:.4f} ms per call) | PyTorch composition "
              f"it replaced {old_ms:.4f} ms | bound {b_ms:.4f} ms (bytes; "
              f"{n_bytes / 1e6:.1f} MB) | launches on the engine paths "
              f"{launches[name]} (slice {launches1[name]})")
        out.append({"name": name, "route": "cuda",
                    "source": "vtgaussian_slam_tpu_torch/csrc/slots.cu",
                    "replaces": None, "launches": launches[name],
                    "max_abs_err": 0.0, "ms": ms, "b2b_ms": b2b_ms,
                    "plain_ms": old_ms, "bound_ms": b_ms, "bound_by": "bytes",
                    "library_ms": None})
    return out


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compare-blend", metavar="DIR", action="append",
                    default=[],
                    help="a directory with another version of blend.cu and "
                         "walk.cuh: hold K4 against that version's, bit for "
                         "bit, and time both (may be given more than once)")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script measures the "
              "port on a GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "vtgaussian_slam_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)

    from vtgaussian_slam_tpu_torch.ops import map_loss as ml
    from vtgaussian_slam_tpu_torch.ops.rasterizer import _build
    from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_blend as cb
    from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_slots as csl
    from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_splat as cs

    # ---- phase 1 ------------------------------------------------------
    card = card_line()
    print(f"[card] {card}")
    print(f"[versions] python {sys.version.split()[0]} torch "
          f"{torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    build_s = _build.build_all()
    print(f"[build] {build_s:.1f} s for {', '.join(_build.SOURCES)}")
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  [{name}] {line.strip()}")

    # ---- phase 2: the slice -------------------------------------------
    from vtgaussian_slam_tpu_torch.core.losses import (RenderResult,
                                                       loss_from_render,
                                                       slam_records)
    from vtgaussian_slam_tpu_torch.core.map_cache import (accum_to_result,
                                                          concat_params,
                                                          pack_fields8,
                                                          trunc_probe)
    from vtgaussian_slam_tpu_torch.models import gaussians as G
    from vtgaussian_slam_tpu_torch.core.pipeline import VTGaussianSLAM
    from vtgaussian_slam_tpu_torch.core.track_cache import build_track_cache
    from vtgaussian_slam_tpu_torch.ops import geometry as geo
    from vtgaussian_slam_tpu_torch.ops.rasterizer.binning import \
        gather_channels
    from vtgaussian_slam_tpu_torch.ops.rasterizer.tiled import (BLEND_CHANNELS,
                                                                blend_image)

    config = room0_proxy_config()
    config["tracking"]["base1_num_iters"] = TRACK_ITERS
    config["mapping"]["num_iters"] = MAP_ITERS
    t0 = time.time()
    engine = VTGaussianSLAM(config, device="cuda")
    torch.cuda.synchronize()
    n0 = engine.sections[0].n_active
    valid0 = int((engine._frame0.depth > 0).sum())
    print(f"[slice] init {time.time() - t0:.2f} s: {n0} gaussians "
          f"({valid0} valid frame-0 pixels), {engine.cam.height}x"
          f"{engine.cam.width}, baseframe_every {engine.bfe}")
    wrappers = {"K1": cs.splat_forward, "K2": cs.splat_backward_pose,
                "K3": cs.splat_backward_vals_rows, "K4": cb.blend_forward,
                "K5": cb.blend_backward, "K6": cs.splat_backward_all,
                "ML": ml.map_loss_forward, "ML_bwd": ml.map_loss_backward,
                "SG": csl.slot_gather, "SI": csl.slot_inverse_sum}
    launches1, times1, q1 = run_frames(engine, NUM_FRAMES, wrappers, valid0,
                                       "slice")
    missing = [k for k in ("K1", "K2", "K3", "K4", "ML", "ML_bwd", "SG", "SI")
               if launches1[k] <= 0]
    assert not missing, f"kernels never launched on the main path: {missing}"

    # ---- phase 2b: the generic route ----------------------------------
    config2 = generic_route_config()
    config2["tracking"]["base1_num_iters"] = TRACK_ITERS
    config2["mapping"]["num_iters"] = MAP_ITERS
    t0 = time.time()
    engine2 = VTGaussianSLAM(config2, device="cuda")
    torch.cuda.synchronize()
    assert not engine2.track_cached and not engine2.map_binned
    print(f"[generic] init {time.time() - t0:.2f} s: "
          f"{engine2.sections[0].n_active} gaussians; tracking and mapping "
          f"render from scratch every iteration (K4 forward, K5 backward)")
    print("[generic] the slice's route on the same frames: " + "; ".join(
        f"frame {t} track {ft['track']:.3f} s densify {ft['densify']:.3f} s "
        f"map {ft['map']:.3f} s" for t, ft in enumerate(times1[:GENERIC_FRAMES])))
    launches2, _, q2 = run_frames(engine2, GENERIC_FRAMES, wrappers, valid0,
                                  "generic")
    missing = [k for k in ("K4", "K5") if launches2[k] <= 0]
    assert not missing, f"kernels never launched on the generic route: {missing}"

    # ---- phase 2b-w2: why the generic route scores lower (W2) ----------
    t0 = time.time()
    launches_w2 = w2_phase(wrappers, valid0, q1, q2)
    print(f"[2b-w2] {time.time() - t0:.1f} s; launches {launches_w2}")

    # ---- phase 2c: section boundaries on the default routes -------------
    config3 = room0_proxy_config()
    config3["baseframe_every"] = BOUNDARY_BFE
    # phase 2f-a resumes from the checkpoint saved after frame 5
    config3["workdir"] = CKPT_WORKDIR
    config3["save_checkpoints"] = True
    config3["checkpoint_interval"] = RESUME_FROM + 1
    import shutil
    shutil.rmtree(CKPT_WORKDIR, ignore_errors=True)
    t0 = time.time()
    engine3 = VTGaussianSLAM(config3, device="cuda")
    torch.cuda.synchronize()
    tr3 = config3["tracking"]
    print(f"[boundaries] init {time.time() - t0:.2f} s: baseframe_every "
          f"{engine3.bfe}, {BOUNDARY_FRAMES} frames, tracking "
          f"{tr3['base1_num_iters']} / {tr3['num_iters']} iterations, mapping "
          f"{config3['mapping']['num_iters']}, selection "
          f"{engine3.dataset_name}, auto pair budget "
          f"{config3['tpu'].get('auto_pair_budget', True)}")
    launches3, refs3 = run_boundaries(engine3, BOUNDARY_FRAMES, wrappers,
                                      valid0, "boundaries", 4)
    missing = [k for k in ("K1", "K2", "K3", "K4") if launches3[k] <= 0]
    assert not missing, f"kernels never launched across boundaries: {missing}"
    # the map and trajectory as the CLI saves them, while a section lies in
    # pinned host memory (phase 2e evaluates them)
    params_ls3 = engine3.export_params_ls()
    check_export(params_ls3, engine3, refs3, "boundaries")
    check_paging(engine3, refs3, "boundaries")
    # the truncation probe at the last frame's pose, at the engine's budget
    # and starved to 128 pairs per tile
    sec_l = engine3.sections[-1]
    t_l = BOUNDARY_FRAMES - 1
    harms = {m: float(trunc_probe(
        sec_l.params, sec_l.active_mask(), engine3.traj.quats[t_l],
        engine3.traj.trans[t_l], engine3.cam,
        span_cap=engine3.backend_kwargs["span_cap"], mpt=m,
        select=engine3._bin_select)) for m in (128, 512)}
    print(f"[boundaries] truncation harm (pixels whose rgb moves > 1/255 "
          f"against 4x the budget) at frame {t_l}'s pose: "
          + ", ".join(f"mpt {m} {h:.5f}" for m, h in harms.items()))
    # W5: the same probe on the global term's binning, [fixed sections;
    # the last section] at its base keyframe, at g_mpt and 4 g_mpt
    gc = engine3._gcache
    g_mpt = gc.tab.shape[1]
    fixed, _ = G.concat_sections(
        [engine3._resident(i) for i in engine3.fixed_section_ids],
        quantum=engine3.quantum)
    g_params = concat_params(fixed.params, sec_l.params)
    g_active = torch.cat([fixed.active_mask(), sec_l.active_mask()])
    g_harms = {m: float(trunc_probe(
        g_params, g_active, gc.quat, gc.trans, engine3.cam,
        span_cap=engine3.backend_kwargs["span_cap"], mpt=m,
        select=engine3._bin_select)) for m in (g_mpt, 4 * g_mpt)}
    del fixed, g_params, g_active
    print(f"[boundaries] W5: truncation harm on the global binning (fixed "
          f"sections {engine3.fixed_section_ids} and section "
          f"{len(engine3.sections) - 1}, {int(gc.counts.shape[0])} rows) at "
          f"its base keyframe's pose: "
          + ", ".join(f"mpt {m} {h:.5f}" for m, h in g_harms.items())
          + f" (above 0.01 at g_mpt {g_mpt}: "
          f"{g_harms[g_mpt] > 0.01})")

    # ---- phase 2d: one boundary on the generic route --------------------
    config4 = generic_route_config()
    config4["baseframe_every"] = GENERIC_BFE
    config4["tracking"]["base1_num_iters"] = TRACK_ITERS
    config4["mapping"]["num_iters"] = MAP_ITERS
    engine4 = VTGaussianSLAM(config4, device="cuda")
    assert not engine4.track_cached and not engine4.map_binned
    launches4, _ = run_boundaries(engine4, GENERIC_BOUNDARY_FRAMES, wrappers,
                                  valid0, "generic boundary", 2)
    assert engine4.fixed_section_ids == (0, 0), engine4.fixed_section_ids
    missing = [k for k in ("K4", "K5") if launches4[k] <= 0]
    assert not missing, f"kernels never launched on the generic boundary: {missing}"

    # ---- phase 2e: the evaluation and the CLI ----------------------------
    import shutil
    from vtgaussian_slam_tpu_torch.eval.evaluate import eval_backend_kwargs
    from vtgaussian_slam_tpu_torch.eval.lpips import lpips_fn
    shutil.rmtree(CLI_WORKDIR, ignore_errors=True)
    lpips = lpips_fn(device="cuda")
    bk_train3 = dict(engine3.backend_kwargs)
    bk_eval3 = eval_backend_kwargs(params_ls3, engine3.cam.height,
                                   engine3.cam.width, config3["tpu"])
    _, launches_e1 = eval_phase(engine3, params_ls3, wrappers, lpips,
                                "eval 2c, training budget", bk_train3)
    _, launches_e2 = eval_phase(engine3, params_ls3, wrappers, lpips,
                                "eval 2c, eval_mode budget", bk_eval3)
    cli_runs = []
    for name, n_frames, n_sec in (("smoke", 11, 3), ("medium", 30, 2)):
        path = os.path.join(REPO, "configs", "synthetic", f"{name}.py")
        tag = f"cli {name}"
        rc, out, wall, lc = cli_run([path, "--set", f"workdir={CLI_WORKDIR}"],
                                    wrappers, tag)
        assert rc == 0, rc
        rdir = os.path.join(CLI_WORKDIR, f"{name}_3")
        res = check_results_dir(rdir, n_frames, n_sec, out, tag)
        ref = JAX_CLI[name]
        inside = (ref["psnr_range"][0] <= res["psnr"] <= ref["psnr_range"][1]
                  and ref["ate_range_cm"][0] <= res["ate_rmse"] * 100
                  <= ref["ate_range_cm"][1]
                  and (ref["l1_range_cm"] is None or ref["l1_range_cm"][0]
                       <= res["depth_l1"] * 100 <= ref["l1_range_cm"][1]))
        print(f"[{tag}] {n_frames} frames, {n_sec} sections, {wall:.2f} s "
              f"wall ({wall / n_frames:.3f} s per frame, eval included) | "
              f"PSNR {res['psnr']:.4f} dB (JAX {ref['psnr']}), MS-SSIM "
              f"{res['ms_ssim']:.6f} (JAX {ref['ms_ssim']}), LPIPS "
              f"{res['lpips']:.6f} ({lpips.source}; JAX not recorded), depth "
              f"L1 {res['depth_l1'] * 100:.4f} cm (JAX {ref['depth_l1_cm']}), "
              f"ATE {res['ate_rmse'] * 100:.2f} cm (JAX {ref['ate_cm']}) | "
              f"inside the JAX package's recorded range (PSNR "
              f"{ref['psnr_range']}, ATE {ref['ate_range_cm']} cm, depth L1 "
              f"{ref['l1_range_cm']} cm): {inside} | launches {lc}")
        cli_runs.append(lc)
        assert all(lc[k] > 0 for k in ("K1", "K2", "K3", "K4")), lc
    # eval_mode re-scores the medium run's map at the budget sized from it,
    # from the results directory's own config.py copy (copying it onto
    # itself would raise SameFileError) and from the original
    rdir = os.path.join(CLI_WORKDIR, "medium_3")
    for src in (os.path.join(rdir, "config.py"),
                os.path.join(REPO, "configs", "synthetic", "medium.py")):
        tag = f"cli medium eval_mode ({os.path.relpath(src, REPO)})"
        rc, out, wall, lc = cli_run(
            [src, "--set", f"workdir={CLI_WORKDIR}", "--set", "eval_mode=True"],
            wrappers, tag)
        assert rc == 0, rc
        res = check_results_dir(rdir, 30, 2, out, tag)
        print(f"[{tag}] {wall:.2f} s | PSNR {res['psnr']:.4f} dB, MS-SSIM "
              f"{res['ms_ssim']:.6f}, LPIPS {res['lpips']:.6f}, depth L1 "
              f"{res['depth_l1'] * 100:.4f} cm, ATE "
              f"{res['ate_rmse'] * 100:.2f} cm | launches {lc}")
        assert lc["K4"] == 30, lc
        cli_runs.append(lc)

    # ---- phase 2f: resume, progress reports, ScanNet++, mesh, dense ------
    f = phase_2f(engine3, config3, params_ls3, refs3, bk_train3, bk_eval3,
                 wrappers)

    # ---- phase 2h: the tile-sharded engine, two ranks on the card -------
    t0 = time.time()
    h2 = sharded_phase(wrappers)
    print(f"[2h] {time.time() - t0:.1f} s")

    runs = (launches1, launches2, launches_w2, launches3, launches4,
            launches_e1, launches_e2, *cli_runs, *f["launches"].values(),
            h2["launches"])
    launches = {k: sum(r[k] for r in runs) for k in wrappers}
    print(f"[launches] slice {launches1}; generic route {launches2}; "
          f"phase 2b-w2 {launches_w2}; boundaries {launches3}; generic "
          f"boundary {launches4}; phase 2c "
          f"eval at the training budget {launches_e1}, at the eval_mode "
          f"budget {launches_e2}; CLI smoke, medium, medium eval_mode x2 "
          f"{cli_runs}; phase 2f {f['launches']}; phase 2h (sharded, both "
          f"ranks) "
          f"{h2['launches']}; K6 launches on the engine paths: "
          f"{launches['K6']} (no engine path calls splat_blend's \"all\" "
          f"mode)")

    # ---- phase 3: kernels against plain, on the slice's inputs ---------
    cam = engine.cam
    tiles_x = -(-cam.width // 16)
    t_last = NUM_FRAMES - 1
    sec = engine.sections[0]
    active = sec.active_mask()
    quat = engine.traj.quats[t_last].clone()
    trans = engine.traj.trans[t_last].clone()
    R9 = geo.quat_to_rotmat(geo.normalize(quat)).reshape(9)
    color_np, depth_np, _, _ = engine.dataset[t_last]
    frame = engine._stage(color_np, depth_np)
    bk = engine.backend_kwargs

    # K1 / K2 inputs: the track cache at the committed pose and the tracking
    # loss cotangent of its accum
    tc = build_track_cache(sec.params, active, quat, trans, cam,
                           span_cap=bk["span_cap"],
                           max_pairs_per_tile=bk["max_pairs_per_tile"],
                           chunk=bk["chunk"], select=engine._bin_select)
    slots_t, counts_t = tc.slots8, tc.counts
    accum_t = cs.splat_forward(slots_t, R9, trans, counts_t, cam, tiles_x)
    acc_v = accum_t.detach().requires_grad_(True)
    img = cs.assemble_image(acc_v, cam)
    r = RenderResult(im=img[:3], depth=img[3:4], silhouette=img[4],
                     depth_sq=img[5:6], radii=tc.radii)
    out = loss_from_render(r, frame, engine._loss_cfg(True), 0.99, True)
    (g_t,) = torch.autograd.grad(out.loss, (acc_v,))
    g_t = g_t.contiguous()

    # K3 inputs: the newest mapping keyframe cache and its loss cotangent
    kfc = engine.map_store.slots[-1]
    f8 = pack_fields8(sec.params)
    kR9 = geo.quat_to_rotmat(geo.normalize(kfc.quat)).reshape(9)
    slots_m = gather_channels(f8, kfc.tab)
    accum_m = cs.splat_forward(slots_m, kR9, kfc.trans, kfc.counts, cam,
                               tiles_x)
    acc_v = accum_m.detach().requires_grad_(True)
    rm = accum_to_result(acc_v, cam)
    ring = engine.map_store.ring_of_slot[-1]
    kframe = type(frame)(color=engine.ring_colors[ring],
                         depth=engine.ring_depths[ring])
    out = loss_from_render(rm, kframe, engine._loss_cfg(False), 0.5, False)
    (g_m,) = torch.autograd.grad(out.loss, (acc_v,))
    g_m = g_m.contiguous()

    # K4 inputs: the densify render's records at the committed pose
    recs, counts4, _ = slam_records(sec.params, active, quat, trans, cam, bk)

    # K4 on phase 2e's eval render of phase 2c's last section at its last
    # frame, from the exported params, at both eval budgets
    from vtgaussian_slam_tpu_torch.models.gaussians import \
        section_from_numpy_params
    sec_e, traj_e = section_from_numpy_params(params_ls3[-1], device="cuda")
    t_e = BOUNDARY_FRAMES - 1
    recs_et, counts_et, _ = slam_records(
        sec_e.params, sec_e.active_mask(), traj_e.quats[t_e],
        traj_e.trans[t_e], cam, bk_train3)
    recs_ee, counts_ee, _ = slam_records(
        sec_e.params, sec_e.active_mask(), traj_e.quats[t_e],
        traj_e.trans[t_e], cam, bk_eval3)
    # K4 on phase 2f-c's render of the ScanNet++ proxy at 584x876 (the
    # probe's and the progress report's input) at its last frame's pose
    pp_sec, pp_q, pp_t, pp_cam, pp_bk = f["probe"]
    recs_pp, counts_pp, _ = slam_records(pp_sec.params, pp_sec.active_mask(),
                                         pp_q, pp_t, pp_cam, pp_bk)
    tiles_x_pp = -(-pp_cam.width // 16)

    # K5 inputs: the generic route's records at its last committed pose and
    # the mapping-loss cotangent of their blend
    t2 = GENERIC_FRAMES - 1
    sec2 = engine2.sections[0]
    lcfg2 = engine2._loss_cfg(False)
    recs5, counts5, radii5 = slam_records(
        sec2.params, sec2.active_mask(), engine2.traj.quats[t2].clone(),
        engine2.traj.trans[t2].clone(), cam, dict(lcfg2.backend_kwargs))
    out5 = cb.blend_forward(recs5, counts5, tiles_x, BLEND_CHANNELS)
    out_v = out5.detach().requires_grad_(True)
    img5 = blend_image(out_v, cam, 6)
    r5 = RenderResult(im=img5[:3], depth=img5[3:4], silhouette=img5[4],
                      depth_sq=img5[5:6], radii=radii5)
    frame2 = engine2._stage(*engine2.dataset[t2][:2])
    out = loss_from_render(r5, frame2, lcfg2, 0.5, False)
    (g5,) = torch.autograd.grad(out.loss, (out_v,))
    g5 = g5.contiguous()

    # K1 / K3 on phase 2c's global binning: [frozen sections; the current
    # section's field table] at its base keyframe, with the global term's
    # mapping-loss cotangent against that keyframe (ring 0)
    gc3 = engine3._gcache
    t_base = (BOUNDARY_FRAMES - 1) // BOUNDARY_BFE * BOUNDARY_BFE
    sec3 = engine3.sections[t_base // BOUNDARY_BFE]
    gR9 = geo.quat_to_rotmat(geo.normalize(gc3.quat)).reshape(9)
    slots_g = gather_channels(
        torch.cat([gc3.fixed_fields8, pack_fields8(sec3.params)]), gc3.tab)
    accum_g = cs.splat_forward(slots_g, gR9, gc3.trans, gc3.counts, cam,
                               tiles_x)
    acc_v = accum_g.detach().requires_grad_(True)
    gframe = type(frame)(color=engine3.ring_colors[0],
                         depth=engine3.ring_depths[0])
    out = loss_from_render(accum_to_result(acc_v, cam), gframe,
                           engine3._loss_cfg(False), 0.5, False)
    (g_g,) = torch.autograd.grad(out.loss, (acc_v,))
    g_g = g_g.contiguous()
    cp_g = cs.cp_vector(gR9, gc3.trans, cam)
    T_g, M_g = slots_g.shape[0], slots_g.shape[2]

    # K2 on the last boundary frame's track cache: the section it tracked
    # against, at the committed pose, with the tracking-loss cotangent
    sec_b = engine3._resident(engine3.section_ids[t_base])
    q_b = engine3.traj.quats[t_base].clone()
    tr_b = engine3.traj.trans[t_base].clone()
    bk3 = engine3.backend_kwargs
    tc_b = build_track_cache(sec_b.params, sec_b.active_mask(), q_b, tr_b,
                             cam, span_cap=bk3["span_cap"],
                             max_pairs_per_tile=bk3["max_pairs_per_tile"],
                             chunk=bk3["chunk"], select=engine3._bin_select)
    slots_b, counts_b = tc_b.slots8, tc_b.counts
    R9b = geo.quat_to_rotmat(geo.normalize(q_b)).reshape(9)
    accum_b = cs.splat_forward(slots_b, R9b, tr_b, counts_b, cam, tiles_x)
    acc_v = accum_b.detach().requires_grad_(True)
    img = cs.assemble_image(acc_v, cam)
    frame_b = engine3._stage(*engine3.dataset[t_base][:2])
    out = loss_from_render(
        RenderResult(im=img[:3], depth=img[3:4], silhouette=img[4],
                     depth_sq=img[5:6], radii=tc_b.radii),
        frame_b, engine3._loss_cfg(True), 0.99, True)
    (g_b,) = torch.autograd.grad(out.loss, (acc_v,))
    g_b = g_b.contiguous()
    cp_b = cs.cp_vector(R9b, tr_b, cam)
    T_b = slots_b.shape[0]

    # K1-K3 with the new operands: a shuffled tile subset of the tracking
    # and the mapping cache (tile ids) and rank 1's tile shard of phase
    # 2h's one-card state (tile offset)
    sub_t = tile_subset_inputs("track cache", slots_t, counts_t, R9, trans,
                               cam, tiles_x, g_t)
    sub_m = tile_subset_inputs("mapping cache", slots_m, kfc.counts, kR9,
                               kfc.trans, cam, tiles_x, g_m)
    sh_t, sh_m = shard_inputs(h2["engine"], h2["launches"], cam, tiles_x)

    cp_t = cs.cp_vector(R9, trans, cam)
    cp_m = cs.cp_vector(kR9, kfc.trans, cam)
    T_t, M_t = slots_t.shape[0], slots_t.shape[2]
    T_m, M_m = slots_m.shape[0], slots_m.shape[2]
    print(f"[kernels] shapes: track slots {tuple(slots_t.shape)}, map slots "
          f"{tuple(slots_m.shape)}, densify records {tuple(recs.shape)}, "
          f"generic-route records {tuple(recs5.shape)}, global binning "
          f"slots {tuple(slots_g.shape)} (phase 2c, frame {t_base}'s "
          f"section {t_base // BOUNDARY_BFE} over fixed sections "
          f"{engine3.fixed_section_ids}), boundary track slots "
          f"{tuple(slots_b.shape)} (frame {t_base})")

    # K6 through splat_blend(grad_mode="all") under autograd (K1 forward,
    # K6 backward, dR / dt contracted and d mean rotated to world by the
    # wrapper), on 128 tiles against the plain rows and in dR / dt against
    # K2's in-kernel contraction of the same inputs
    print("[K6] splat_blend(grad_mode=\"all\") under autograd")
    sv = slots_t.detach().clone().requires_grad_(True)
    Rv = R9.detach().clone().requires_grad_(True)
    tv = trans.detach().clone().requires_grad_(True)
    n6 = cs.splat_backward_all.launches
    cs.splat_blend(sv, Rv, tv, counts_t, cam, tiles_x,
                   grad_mode="all").backward(g_t)
    assert cs.splat_backward_all.launches == n6 + 1
    ids6 = pick_tiles(counts_t)
    p6 = cs.splat_backward_all_plain(slots_t[ids6], counts_t[ids6], cp_t,
                                     tiles_x, accum_t[ids6], g_t[ids6], ids6)
    p6w = torch.cat([torch.einsum("ij,tjm->tim", R9.reshape(3, 3).T,
                                  p6[:, :3]), p6[:, 3:]], 1)
    check_close("K6 d slots (world)", sv.grad[ids6].transpose(1, 2),
                p6w.transpose(1, 2), 1e-3)
    pose2 = cs.splat_backward_pose(slots_t, R9, trans, counts_t, accum_t, g_t,
                                   cam, tiles_x).sum(0)
    check_close("K6 dR, dt vs K2", torch.cat([Rv.grad, tv.grad])[:, None],
                pose2[:, None], 1e-3)

    work_t = splat_work(slots_t, counts_t, cp_t, tiles_x)   # K1, K2 and K6
    work_5 = blend_work(recs5, counts5, tiles_x)    # K5, and K4's other input
    work_g = splat_work(slots_g, gc3.counts, cp_g, tiles_x)    # K1, K3 global
    global_tag = f"global binning at g_mpt {M_g}"
    # records no pixel walks are not read: count the walked ones
    k4_bytes = lambda r: lambda s: (s * (6 + BLEND_CHANNELS) * 4
                                    + r.shape[0] * 4
                                    + r.shape[0] * 256 * BLEND_CHANNELS * 4)
    report = []
    specs = {
        "K1": dict(
            route="cuda", source="vtgaussian_slam_tpu_torch/csrc/splat.cu",
            replaces="vtgaussian_slam_tpu/ops/rasterizer/pallas_splat.py:606",
            kernel=lambda: cs.splat_forward(slots_t, R9, trans, counts_t, cam,
                                            tiles_x),
            plain=lambda ids: cs.splat_forward_plain(
                slots_t[ids], counts_t[ids], cp_t, tiles_x, ids),
            T=T_t, sub=lambda o, ids: o[ids].transpose(1, 2), tol=3e-4,
            bytes=lambda s: s * 8 * 4 + T_t * 4 + T_t * 8 * 256 * 4,
            work=lambda: work_t,
            also=[dict(
                tag=global_tag, counts=gc3.counts,
                kernel=lambda: cs.splat_forward(slots_g, gR9, gc3.trans,
                                                gc3.counts, cam, tiles_x),
                plain=lambda ids: cs.splat_forward_plain(
                    slots_g[ids], gc3.counts[ids], cp_g, tiles_x, ids),
                bytes=lambda s: s * 8 * 4 + T_g * 4 + T_g * 8 * 256 * 4,
                work=lambda: work_g), sub_t["K1"], sub_m["K1"],
                sh_t["K1"]]),
        "K2": dict(
            route="cuda", source="vtgaussian_slam_tpu_torch/csrc/splat.cu",
            replaces="vtgaussian_slam_tpu/ops/rasterizer/pallas_splat.py:641",
            kernel=lambda: cs.splat_backward_pose(slots_t, R9, trans, counts_t,
                                                  accum_t, g_t, cam, tiles_x),
            plain=lambda ids: cs.splat_backward_pose_plain(
                slots_t[ids], counts_t[ids], cp_t, tiles_x, accum_t[ids],
                g_t[ids], ids),
            T=T_t, sub=lambda o, ids: o[ids], tol=1e-3,
            bytes=lambda s: (s * 8 * 4 + T_t * 4 + 2 * T_t * 8 * 256 * 4
                             + T_t * 12 * 4),
            work=lambda: work_t,
            also=[dict(
                tag=f"frame {t_base}'s boundary track cache",
                counts=counts_b,
                kernel=lambda: cs.splat_backward_pose(
                    slots_b, R9b, tr_b, counts_b, accum_b, g_b, cam, tiles_x),
                plain=lambda ids: cs.splat_backward_pose_plain(
                    slots_b[ids], counts_b[ids], cp_b, tiles_x, accum_b[ids],
                    g_b[ids], ids),
                bytes=lambda s: (s * 8 * 4 + T_b * 4 + 2 * T_b * 8 * 256 * 4
                                 + T_b * 12 * 4),
                work=lambda: splat_work(slots_b, counts_b, cp_b, tiles_x)),
                sub_t["K2"], sh_t["K2"]]),
        "K3": dict(
            route="cuda", source="vtgaussian_slam_tpu_torch/csrc/splat.cu",
            replaces="vtgaussian_slam_tpu/ops/rasterizer/pallas_splat.py:641",
            kernel=lambda: cs.splat_backward_vals_rows(
                slots_m, kR9, kfc.trans, kfc.counts, accum_m, g_m, cam,
                tiles_x),
            plain=lambda ids: cs.splat_backward_vals_rows_plain(
                slots_m[ids], kfc.counts[ids], cp_m, tiles_x, accum_m[ids],
                g_m[ids], ids),
            T=T_m, sub=lambda o, ids: o[ids], tol=1e-3,
            bytes=lambda s: (s * 8 * 4 + T_m * 4 + 2 * T_m * 8 * 256 * 4
                             + T_m * M_m * 8 * 4),
            work=lambda: splat_work(slots_m, kfc.counts, cp_m, tiles_x),
            also=[dict(
                tag=global_tag, counts=gc3.counts,
                kernel=lambda: cs.splat_backward_vals_rows(
                    slots_g, gR9, gc3.trans, gc3.counts, accum_g, g_g, cam,
                    tiles_x),
                plain=lambda ids: cs.splat_backward_vals_rows_plain(
                    slots_g[ids], gc3.counts[ids], cp_g, tiles_x,
                    accum_g[ids], g_g[ids], ids),
                bytes=lambda s: (s * 8 * 4 + T_g * 4 + 2 * T_g * 8 * 256 * 4
                                 + T_g * M_g * 8 * 4),
                work=lambda: work_g), sub_m["K3"], sh_m["K3"]]),
        "K4": dict(
            route="cuda", source="vtgaussian_slam_tpu_torch/csrc/blend.cu",
            replaces="vtgaussian_slam_tpu/ops/rasterizer/pallas_blend.py:246",
            kernel=lambda: cb.blend_forward(recs, counts4, tiles_x,
                                            BLEND_CHANNELS),
            plain=lambda ids: cb.blend_forward_plain(
                recs[ids], counts4[ids], tiles_x, BLEND_CHANNELS, ids),
            T=recs.shape[0], sub=lambda o, ids: o[ids], tol=3e-4,
            bytes=k4_bytes(recs),
            work=lambda: blend_work(recs, counts4, tiles_x),
            # its other input: most of its launches see such records
            also=[dict(
                tag="generic-route records", counts=counts5,
                kernel=lambda: cb.blend_forward(recs5, counts5, tiles_x,
                                                BLEND_CHANNELS),
                plain=lambda ids: cb.blend_forward_plain(
                    recs5[ids], counts5[ids], tiles_x, BLEND_CHANNELS, ids),
                bytes=k4_bytes(recs5), work=lambda: work_5),
                  dict(tag=f"phase 2c eval render at the training budget "
                           f"(mpt {recs_et.shape[2]})", counts=counts_et,
                       launches=launches_e1["K4"],
                       kernel=lambda: cb.blend_forward(
                           recs_et, counts_et, tiles_x, BLEND_CHANNELS),
                       plain=lambda ids: cb.blend_forward_plain(
                           recs_et[ids], counts_et[ids], tiles_x,
                           BLEND_CHANNELS, ids),
                       bytes=k4_bytes(recs_et),
                       work=lambda: blend_work(recs_et, counts_et, tiles_x)),
                  dict(tag=f"phase 2c eval render at the eval_mode budget "
                           f"(mpt {recs_ee.shape[2]})", counts=counts_ee,
                       launches=launches_e2["K4"],
                       kernel=lambda: cb.blend_forward(
                           recs_ee, counts_ee, tiles_x, BLEND_CHANNELS),
                       plain=lambda ids: cb.blend_forward_plain(
                           recs_ee[ids], counts_ee[ids], tiles_x,
                           BLEND_CHANNELS, ids),
                       bytes=k4_bytes(recs_ee),
                       work=lambda: blend_work(recs_ee, counts_ee, tiles_x)),
                  dict(tag=f"phase 2f-c ScanNet++ render at {pp_cam.height}x"
                           f"{pp_cam.width} (mpt {recs_pp.shape[2]})",
                       counts=counts_pp,
                       launches=f["launches"]["scannetpp"]["K4"],
                       kernel=lambda: cb.blend_forward(
                           recs_pp, counts_pp, tiles_x_pp, BLEND_CHANNELS),
                       plain=lambda ids: cb.blend_forward_plain(
                           recs_pp[ids], counts_pp[ids], tiles_x_pp,
                           BLEND_CHANNELS, ids),
                       bytes=k4_bytes(recs_pp),
                       work=lambda: blend_work(recs_pp, counts_pp,
                                               tiles_x_pp))]),
        "K5": dict(
            route="cuda", source="vtgaussian_slam_tpu_torch/csrc/blend.cu",
            replaces="vtgaussian_slam_tpu/ops/rasterizer/pallas_blend.py:274",
            kernel=lambda: cb.blend_backward(recs5, counts5, out5, g5,
                                             tiles_x),
            plain=lambda ids: cb.blend_backward_plain(
                recs5[ids], counts5[ids], out5[ids], g5[ids], tiles_x, ids),
            T=recs5.shape[0], sub=lambda o, ids: o[ids], tol=1e-3,
            # walked records are read, every record row is written
            bytes=lambda s: (s * (6 + BLEND_CHANNELS) * 4
                             + recs5.shape[0] * 4
                             + 2 * recs5.shape[0] * 256 * BLEND_CHANNELS * 4
                             + recs5.shape[0] * recs5.shape[2] * 16 * 4),
            work=lambda: work_5),
        "K6": dict(
            route="cuda", source="vtgaussian_slam_tpu_torch/csrc/splat.cu",
            replaces="vtgaussian_slam_tpu/ops/rasterizer/pallas_splat.py:641",
            kernel=lambda: cs.splat_backward_all(slots_t, R9, trans, counts_t,
                                                 accum_t, g_t, cam, tiles_x),
            plain=lambda ids: cs.splat_backward_all_plain(
                slots_t[ids], counts_t[ids], cp_t, tiles_x, accum_t[ids],
                g_t[ids], ids),
            T=T_t, sub=lambda o, ids: o[ids].transpose(1, 2), tol=1e-3,
            bytes=lambda s: (s * 8 * 4 + T_t * 4 + 2 * T_t * 8 * 256 * 4
                             + T_t * 8 * M_t * 4),
            work=lambda: work_t),
    }
    counts_of = {"K1": counts_t, "K2": counts_t, "K3": kfc.counts,
                 "K4": counts4, "K5": counts5, "K6": counts_t}
    times = {}
    for name, sp in specs.items():
        print(f"[{name}] vs plain on 128 tiles")
        full = sp["kernel"]()
        torch.cuda.synchronize()
        ids = pick_tiles(counts_of[name])
        ref = sp["plain"](ids)
        got = sp["sub"](full, ids)
        ref_cmp = ref.transpose(1, 2) if name in ("K1", "K6") else ref
        err = check_close(name, got, ref_cmp, sp["tol"])
        same = torch.equal(full, sp["kernel"]())
        print(f"  {name}: a repeated launch gives the same bits: {same}")
        if not same:
            raise AssertionError(f"{name} is not deterministic")
        if name == "K2":
            k2_precision(got, ref_cmp, slots_t[ids], counts_t[ids], cp_t,
                         tiles_x, accum_t[ids], g_t[ids], ids)
        # one wrapper call; and 20 calls back to back, per call
        ms = times[name] = event_ms(sp["kernel"])
        b2b_ms = event_ms(sp["kernel"], per=20)

        def plain_all():
            for b in batched(sp["T"], 64):
                sp["plain"](b)
        plain_ms = event_ms(plain_all, iters=1, warmup=1)
        work = sp["work"]()
        b_ms, b_by = bound(name, sp["bytes"](work["slots"]), work)
        print(f"  {name}: {ms:.4f} ms (one wrapper call, median; 20 calls "
              f"back to back {b2b_ms:.4f} ms per call) | plain {plain_ms:.2f} "
              f"ms | bound {b_ms:.4f} ms ({b_by}; {work['walked']} pairs "
              f"walked, {work['blended']} blended, {work['slots']} slots "
              f"walked) | launches on the engine paths {launches[name]} "
              f"(slice {launches1[name]}, generic route {launches2[name]}, "
              f"phase 2b-w2 {launches_w2[name]}, "
              f"boundaries {launches3[name]}, generic boundary "
              f"{launches4[name]}, phase 2e evaluations "
              f"{launches_e1[name] + launches_e2[name]}, CLI runs "
              f"{sum(r[name] for r in cli_runs)}, phase 2f "
              f"{sum(r[name] for r in f['launches'].values())}, phase 2h "
              f"{h2['launches'][name]})")
        if name != "K6":    # K6 walks K2's inputs
            steps_line(name, work, sub_chunks=name not in ("K1", "K4"))
        row = {"name": name, "route": sp["route"],
               "source": sp["source"], "replaces": sp["replaces"],
               "launches": launches[name], "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": None}
        for also in sp.get("also", []):
            print(f"[{name}] on the {also['tag']}, vs plain on 128 tiles")
            full = also["kernel"]()
            ids = pick_tiles(also["counts"])
            ref = also["plain"](ids)
            err2 = check_close(name, sp["sub"](full, ids),
                               ref.transpose(1, 2) if name in ("K1", "K6")
                               else ref, sp["tol"])
            same = torch.equal(full, also["kernel"]())
            print(f"  {name}: a repeated launch gives the same bits: {same}")
            if not same:
                raise AssertionError(f"{name} is not deterministic")
            ms2 = event_ms(also["kernel"])
            b2b2 = event_ms(also["kernel"], per=20)
            work2 = also["work"]()
            b2_ms, b2_by = bound(name, also["bytes"](work2["slots"]), work2)
            print(f"  {name}: {ms2:.4f} ms (one wrapper call, median; 20 "
                  f"calls back to back {b2b2:.4f} ms per call) | bound "
                  f"{b2_ms:.4f} ms ({b2_by}; {work2['walked']} pairs walked, "
                  f"{work2['blended']} blended, {work2['slots']} slots "
                  f"walked)")
            if name != "K6":
                steps_line(name, work2, sub_chunks=name not in ("K1", "K4"))
            entry = {"input": also["tag"], "max_abs_err": err2, "ms": ms2,
                     "bound_ms": b2_ms, "bound_by": b2_by}
            if "launches" in also:
                entry["launches"] = also["launches"]
            row.setdefault("other_inputs", []).append(entry)
        report.append(row)

    report.append(map_loss_row(rm, kframe, engine._loss_cfg(False),
                               launches, launches1))
    rows_m = cs.splat_backward_vals_rows(slots_m, kR9, kfc.trans, kfc.counts,
                                         accum_m, g_m, cam, tiles_x)
    report.extend(slot_rows(f8, kfc, rows_m.reshape(-1, 8), launches,
                            launches1))

    print(f"[ratios] same run: K5/K4 {times['K5'] / times['K4']:.3f}, "
          f"K2/K1 {times['K2'] / times['K1']:.3f}, "
          f"K3/K1 {times['K3'] / times['K1']:.3f}")

    for src_dir in args.compare_blend:
        other = other_blend_forward(src_dir)
        for tag, r, c in (("densify records", recs, counts4),
                          ("generic-route records", recs5, counts5)):
            mine = cb.blend_forward(r, c, tiles_x, BLEND_CHANNELS)
            theirs = other(r, c, tiles_x, BLEND_CHANNELS)
            run_other = lambda: other(r, c, tiles_x, BLEND_CHANNELS)
            run_mine = lambda: cb.blend_forward(r, c, tiles_x, BLEND_CHANNELS)
            print(f"[K4 vs {src_dir}] {tag}: equal to the bit: "
                  f"{torch.equal(mine, theirs)}; max abs difference "
                  f"{(mine - theirs).abs().max().item():.3e}; one call "
                  f"{event_ms(run_mine):.4f} ms against "
                  f"{event_ms(run_other):.4f} ms, 20 back to back "
                  f"{event_ms(run_mine, per=20):.4f} against "
                  f"{event_ms(run_other, per=20):.4f} ms per call")

    # ---- phase 3b: the loops' device-busy share -------------------------
    from vtgaussian_slam_tpu_torch.core.mapping import (KeyframeBuffer,
                                                        MappingConfig,
                                                        map_frame_binned)
    from vtgaussian_slam_tpu_torch.core.tracking import (TrackingConfig,
                                                         init_track_state,
                                                         track_frame,
                                                         track_frame_cached)
    assert engine.dataset_name == "replica"    # no far-depth mask in _track
    tr_cfg, mp_cfg = config["tracking"], config["mapping"]

    def tcfg_of(eng):
        return TrackingConfig(
            num_iters=BUSY_ITERS, lr_quat=tr_cfg["lrs"]["cam_unnorm_rots"],
            lr_trans=tr_cfg["lrs"]["cam_trans"], metric="loss",
            loss_cfg=eng._loss_cfg(True))

    mcfg = MappingConfig(
        num_iters=BUSY_ITERS,
        lrs=tuple(sorted((k, float(v)) for k, v in mp_cfg["lrs"].items()
                         if k not in ("cam_unnorm_rots", "cam_trans"))),
        loss_cfg=engine._loss_cfg(False), use_global=False)
    kf = KeyframeBuffer(colors=engine.ring_colors, depths=engine.ring_depths,
                        count=len(engine.map_store.ring_of_slot))
    q2 = engine2.traj.quats[t2].clone()
    tr2 = engine2.traj.trans[t2].clone()
    busy_line("default track", lambda: track_frame_cached(
        tc, init_track_state(quat, trans, tr_cfg["sil_thres"]), frame, None,
        cam, tcfg_of(engine)))
    busy_line("default map", lambda: map_frame_binned(
        sec.params, kf, engine.map_store.slots,
        list(engine.map_store.ring_of_slot), cam, mcfg,
        generator=engine.map_generator))
    busy_line("generic track", lambda: track_frame(
        sec2.params, sec2.active_mask(),
        init_track_state(q2, tr2, tr_cfg["sil_thres"]), frame2, None, cam,
        tcfg_of(engine2)))
    # the replica boundary loop of frame t_base: the p2p candidate metric
    # (back-projection, projection and a row gather) every iteration
    assert engine3.dataset_name == "replica"
    p2p_b = engine3._overlap_p2p_target(engine3.earliest_corr[-1][0])
    tcfg_b = tcfg_of(engine3)._replace(metric="p2p",
                                       p2p_method=tr3["p2p_method"])
    busy_line("boundary track (p2p)", lambda: track_frame_cached(
        tc_b, init_track_state(q_b, tr_b, tr3["sil_thres"]), frame_b, None,
        cam, tcfg_b, p2p_b))
    print(json.dumps({"kernels": report}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
