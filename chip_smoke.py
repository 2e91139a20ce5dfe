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
     inverse map and autograd); frame 0 + 2 tracked frames at the same
     iteration budgets, printed beside the slice's times for the same
     frames, under the same guards, with its own zeroed launch counts;
  2c. section boundaries on the default routes: the same proxy with
     baseframe_every 3 for 10 frames (60 tracking iterations, 80 on the
     first section, 100 mapping iterations, the pair budget's closed loop
     on): boundaries at frames 3, 6 and 9 select the overlapping sections,
     track with the point-to-plane candidate metric and spawn sections 1-3;
     later frames map with the global term over two frozen sections, and
     sections outside the hot set are paged to pinned host memory. Per
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
  3. each kernel against its plain PyTorch version on inputs captured from
     the two runs' final states (the track cache and its loss cotangent for
     K1, K2 and K6, one mapping keyframe cache and its cotangent for K3,
     the densify render records for K4, the generic route's records and its
     mapping-loss cotangent for K5), on 128 tiles (the 64 fullest + 64
     random), with the tolerance stated; K4 also on the generic route's
     records, the input of all its launches but densify's, and on phase
     2e's eval render of phase 2c's last section at its last frame, at the
     training budget and at the eval_mode budget; K1 and K3 also
     on phase 2c's global binning (the frozen sections and the current
     one, at g_mpt) with the global term's loss cotangent, and K2 also on
     the track cache of phase 2c's last boundary frame, each with that
     input's own time, bound and step counts; K6, which no engine path launches,
     also runs through `splat_blend(grad_mode="all")` under autograd, held
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
     beside it) on both of K4's inputs: whether the two outputs are equal
     to the bit, the largest difference, and both times;
  3b. the device-busy share of the loops (`[busy]` lines): ten iterations
     each of the default tracking loop, the default mapping loop, the
     generic tracking loop and the replica boundary tracking loop with its
     p2p target (phase 2c's frame 9) on the runs' final states, once timed by the
     host clock alone and once under `torch.profiler`: the summed device
     time over the unprofiled wall time, the launches per iteration and the
     five kernels with the most device time;
  4. a `{"kernels": [...]}` line (launches: the sum over the engine runs
     and phase 2e's evaluations and CLI runs); the card line; and as the
     last line
     `{"ok": true, "device": {...}}`.

It needs one CUDA card and the repository checkout around it: without
either it prints the reason and exits non-zero.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
NUM_FRAMES = 5
GENERIC_FRAMES = 3    # frame 0 + 2 tracked frames on the generic route
BOUNDARY_BFE, BOUNDARY_FRAMES = 3, 10     # phase 2c: four sections
GENERIC_BFE, GENERIC_BOUNDARY_FRAMES = 2, 4   # phase 2d: one boundary
TRACK_ITERS = 80      # room0 base1_num_iters
MAP_ITERS = 100       # room0 mapping num_iters
BUSY_ITERS = 10       # iterations of each loop under the profiler
CLI_WORKDIR = os.path.join(REPO, "build", "chip_smoke_cli")
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


def run_frames(engine, n, wrappers, valid0, tag):
    """Drive `engine.process_frame` for frames 0..n-1 with every kernel
    count zeroed just before and read just after; print the per-frame
    split, quality and the guards, and return (launches, per-frame times)."""
    import numpy as np
    import torch
    zeroed(wrappers)
    rows = []
    t_run = time.time()
    for t in range(n):
        engine.process_frame(t)
        rows.append((t, engine.frame_times[t], engine.sections[0].n_active,
                     engine.map_backend_kwargs["max_pairs_per_tile"]))
    torch.cuda.synchronize()
    run_s = time.time() - t_run
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"[{tag}] {n} frames in {run_s:.2f} s; launches {launches}")
    psnrs, l1s = [], []
    for t, ft, n_act, mpt in rows:
        psnr, l1 = engine.evaluate_frame(t)
        psnrs.append(psnr)
        l1s.append(l1)
        print(f"[{tag} frame {t}] track {ft['track']:.3f} s densify "
              f"{ft['densify']:.3f} s map {ft['map']:.3f} s ({stage(ft)}) | "
              f"n_active {n_act} | mpt {mpt} | PSNR {psnr:.2f} dB | depth L1 "
              f"{l1 * 100:.3f} cm")
    ate = engine.ate(n)
    print(f"[{tag}] ATE {ate * 100:.4f} cm (bound < 5 cm); min PSNR "
          f"{min(psnrs):.2f} dB (bound > 20 dB); n_active "
          f"{engine.sections[0].n_active} (bound >= {valid0}); tracking "
          f"tiles at the pair budget, max share "
          f"{engine.stats['tile_truncation_frac_max']:.4f}")
    vals = psnrs + l1s + [ate]
    assert all(np.isfinite(v) for v in vals), vals
    assert engine.sections[0].n_active >= valid0
    assert ate < 0.05, ate
    assert min(psnrs) > 20.0, psnrs
    return launches, [ft for _, ft, _, _ in rows]


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
    for t in range(n):
        engine.process_frame(t)
        for i in engine._page_pending:
            if i not in refs:
                refs[i] = [x.clone() for x in
                           section_tensors(engine.sections[i])]
        gc = engine._gcache
        rows.append(dict(
            t=t, ft=engine.frame_times[t], sec=engine.section_ids[t],
            n=engine.sections[t // bfe].n_active,
            mpt=engine.map_backend_kwargs["max_pairs_per_tile"],
            g_mpt=None if gc is None else gc.tab.shape[1],
            fixed=engine.fixed_section_ids,
            probes=engine.probe_log[n_probe:], boost=engine._mpt_boost,
            corr=((engine.tracking_corr[-1:], engine.earliest_corr[-1:])
                  if t and t % bfe == 0 else None),
            paged=engine.paged_sections()))
        n_probe = len(engine.probe_log)
    engine._page_cold_finish()
    torch.cuda.synchronize()
    run_s = time.time() - t_run
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"[{tag}] {n} frames in {run_s:.2f} s; launches {launches}")
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
              f"{l1 * 100:.3f} cm | host sections {r['paged']}")
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


def splat_work(slots8, counts, cp, tiles_x):
    """`walk_counts` of the splat kernels on these inputs, over all tiles."""
    from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_splat as cs
    n = [0] * len(WORK_KEYS)
    for ids in batched(slots8.shape[0], 128):
        w = cs._walk(slots8[ids], counts[ids], cp, tiles_x, ids)
        box = cs.slot_box(slots8[ids], cp, tiles_x, ids, w["q"])
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
        err = fn(recs.data_ptr(), counts.data_ptr(), recs.shape[0],
                 recs.shape[2], tiles_x, n_channels, out.data_ptr(),
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

    from vtgaussian_slam_tpu_torch.ops.rasterizer import _build
    from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_blend as cb
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
                                                          pack_fields8,
                                                          trunc_probe)
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
                "K5": cb.blend_backward, "K6": cs.splat_backward_all}
    launches1, times1 = run_frames(engine, NUM_FRAMES, wrappers, valid0,
                                   "slice")
    missing = [k for k in ("K1", "K2", "K3", "K4") if launches1[k] <= 0]
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
    launches2, _ = run_frames(engine2, GENERIC_FRAMES, wrappers, valid0,
                              "generic")
    missing = [k for k in ("K4", "K5") if launches2[k] <= 0]
    assert not missing, f"kernels never launched on the generic route: {missing}"

    # ---- phase 2c: section boundaries on the default routes -------------
    config3 = room0_proxy_config()
    config3["baseframe_every"] = BOUNDARY_BFE
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

    runs = (launches1, launches2, launches3, launches4, launches_e1,
            launches_e2, *cli_runs)
    launches = {k: sum(r[k] for r in runs) for k in wrappers}
    print(f"[launches] slice {launches1}; generic route {launches2}; "
          f"boundaries {launches3}; generic boundary {launches4}; phase 2c "
          f"eval at the training budget {launches_e1}, at the eval_mode "
          f"budget {launches_e2}; CLI smoke, medium, medium eval_mode x2 "
          f"{cli_runs}; K6 launches on the engine paths: {launches['K6']} "
          f"(no engine path calls splat_blend's \"all\" mode)")

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
                work=lambda: work_g)]),
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
                work=lambda: splat_work(slots_b, counts_b, cp_b, tiles_x))]),
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
                work=lambda: work_g)]),
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
                       work=lambda: blend_work(recs_ee, counts_ee, tiles_x))]),
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
              f"boundaries {launches3[name]}, generic boundary "
              f"{launches4[name]}, phase 2e evaluations "
              f"{launches_e1[name] + launches_e2[name]}, CLI runs "
              f"{sum(r[name] for r in cli_runs)})")
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
