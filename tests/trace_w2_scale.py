"""W2 at sizes where the pair-budget rule runs as on the card: the JAX
package's own route gap, and the port's share of it (CPU, both packages; a
diagnostic, not a test: pytest does not collect it; no device metric).

    JAX_PLATFORMS=cpu python tests/trace_w2_scale.py [--sizes 96x176,170x300]
        [--frames 5] [--iters 20,25] [--nudges depth,colour,both]
        [--share 0.97 | --mpt M] [--frame-one]

The generic route (track_cache / map_binned off) renders through the
tiled blend, which keeps each tile's depth prefix of `max_pairs_per_tile`
pairs; the default routes train on importance binning. On the card
(chip_smoke phase 2b, 680x1200, 3225 tiles) the generic route scores 2-12
dB lower per frame and densifies ~17x as much at frame 1. The 48x64 proxy
of tests/test_torch_truncation_parity.py has 12 tiles, under the 64 at
which `auto_pair_budget` divides by 12 instead of 4, so it never runs the
card's budget rule.

For each size HxW (96x176: 66 tiles; 170x300, room0 / 4: 209 tiles) the
room0 proxy's synthetic scene (`make_config("replica", "room0proxy")`,
synthetic seed 0, motion 0.05, densification stream at 2H x 2W), with the
tracking / mapping iterations cut to --iters, runs through
- the JAX engine on the default routes (track cache, binned mapping, both
  on; its splat kernels in Pallas interpret mode) and on the generic route
  (its XLA blend: `use_pallas` is off on the CPU);
- the port on both routes, with the JAX run's keyframe draws injected
  (`test_torch_boundaries._Recorder`), its plain versions of the kernels;
- the JAX engine again on frames one ulp up (--nudges, of
  torch_port_util.NUDGES), for its own rounding spread.
The pair budget is the multiple of 128 at which the share of the tiles of
the frame-0 map (at frame 0's pose) that reach it comes closest to
--share (the card's default route reads ~0.97 at mpt 512), or --mpt.

Per frame and run it prints the densify count (`num_gs_per_frame_ls`),
the share of tiles at the pair budget of a binning at the committed pose
(the port's `bin_gaussians` on the run's map after that frame), and the
PSNR of the final map through its package's `eval_sequence` at the
training budget and at `eval_backend_kwargs`' budget. Then, per size:
- W2 = default - generic per frame and budget, for JAX and the port, and
  the port's share of it (port minus JAX) against max(2 x the JAX
  engine's one-ulp spread of W2, 0.05 dB), test_torch_truncation_parity's
  yardstick;
- the densify counts: port minus JAX against max(2 x the JAX engine's
  one-ulp spread of the count, 1% of it, 5);
- D4: JAX shows the card's sign (generic below default at the eval
  budget on every frame after the first, and a frame-1 densify burst: the
  generic route's count at least twice the default's) and the port equals
  JAX on both yardsticks.
Then the same runs at the smallest power of two above every run's largest
pair count per tile, where no tile truncates (chip_smoke's variant 4):
JAX's own route gap there, and whether the port equals JAX.
--frame-one runs `frame_one` instead: where the default route's frame 1
parts between the packages, and whether it parts when both start from
the JAX engine's frame-0 map.
Each engine run is timed with torch on one thread.
"""
import argparse
import contextlib
import io
import os
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

from configs.common import make_config  # noqa: E402
from test_torch_boundaries import _Recorder  # noqa: E402
from torch_port_util import NUDGES, one_ulp_frames  # noqa: E402
from vtgaussian_slam_tpu.core import pipeline as JP  # noqa: E402
from vtgaussian_slam_tpu.core import track_cache as JTC  # noqa: E402
from vtgaussian_slam_tpu.eval import evaluate as JE  # noqa: E402
from vtgaussian_slam_tpu.ops import image as JI  # noqa: E402
from vtgaussian_slam_tpu_torch.core import pipeline as TP  # noqa: E402
from vtgaussian_slam_tpu_torch.core import track_cache as TTC  # noqa: E402
from vtgaussian_slam_tpu_torch.core.track_cache import project_at  # noqa: E402
from vtgaussian_slam_tpu_torch.eval import evaluate as TE  # noqa: E402
from vtgaussian_slam_tpu_torch.models.gaussians import \
    GaussianParams  # noqa: E402
from vtgaussian_slam_tpu_torch.ops.rasterizer.binning import \
    bin_gaussians  # noqa: E402

SPREAD_K = 2.0
FLOOR_DB = 0.05
# densify counts: at least 1% of JAX's count, and at least one pixel's
# worth (a pixel whose silhouette flips adds one Gaussian of the frame and
# up to four of the 2x densification stream)
DENSIFY_SHARE, DENSIFY_PIXEL = 0.01, 5
COUNT_CAP = 1 << 14
ROUTES = ("default", "generic")


def w2_config(h, w, generic, mpt, iters, workdir):
    """The room0 proxy at h x w (densification 2h x 2w) on one route."""
    c = make_config("replica", "room0proxy", seed=2)
    c.update(use_wandb=False, workdir=workdir)
    c["data"] = dict(
        dataset_name="synthetic",
        synthetic=dict(num_frames=40, height=h, width=w, seed=0,
                       motion_scale=0.05),
        sequence="room0proxy", desired_image_height=h, desired_image_width=w,
        densification_image_height=2 * h, densification_image_width=2 * w,
        start=0, end=-1, stride=1, num_frames=-1)
    c["tracking"]["num_iters"] = c["tracking"]["base1_num_iters"] = iters[0]
    c["mapping"]["num_iters"] = iters[1]
    c["tpu"].update(max_pairs_per_tile=mpt, track_cache=not generic,
                    map_binned=not generic)
    return c


def tile_counts(params, n_active, quat, trans, cam, span, mpt):
    """Pairs per tile of a map (numpy fields) at a pose, counted up to mpt
    (the port's binning; the JAX package's is equal to the bit)."""
    t = lambda x: torch.as_tensor(np.array(x, np.float32))
    p = GaussianParams(*(t(getattr(params, f)) for f in (
        "means3d", "rgb_colors", "unnorm_rotations", "logit_opacities",
        "log_scales")))
    active = torch.arange(p.capacity) < int(n_active)
    proj = project_at(p, active, t(quat), t(trans), cam)
    return bin_gaussians(proj, 16, span, -(-cam.width // 16),
                         -(-cam.height // 16), mpt).counts.numpy()


def budget_for(h, w, iters, share, mpt=None):
    """The multiple of 128 that the share of the frame-0 map's tiles
    reaching it at frame 0's pose puts closest to `share` (or `mpt`)."""
    cfg = w2_config(h, w, False, 512, iters, tempfile.mkdtemp())
    eng = TP.VTGaussianSLAM(cfg, device="cpu")
    sec = eng.sections[0]
    c = tile_counts(sec.params, sec.n_active, eng.traj.quats[0],
                    eng.traj.trans[0], eng.cam, cfg["tpu"]["span_cap"],
                    COUNT_CAP)
    eng.close()
    if mpt is None:
        mpt = min(range(128, int(c.max()) + 129, 128),
                  key=lambda m: (abs((c >= m).mean() - share), -m))
    print(f"[{h}x{w}] {c.size} tiles; frame-0 map ({int(sec.n_active)} "
          f"Gaussians): pairs per tile mean {c.mean():.0f} p1 "
          f"{np.quantile(c, 0.01):.0f} p50 {np.median(c):.0f} p99 "
          f"{np.quantile(c, 0.99):.0f} max {c.max()} "
          f"-> mpt {mpt} ({(c >= mpt).mean():.4f} of the tiles reach it)",
          flush=True)
    return mpt


def scores(eng, E, cfg, frames, out_dir, **kw):
    """Per-frame PSNR of the final map at the training budget and at
    eval_backend_kwargs' budget, through the package's eval_sequence."""
    h = cfg["data"]["desired_image_height"]
    w = cfg["data"]["desired_image_width"]
    params_ls = eng.export_params_ls()
    budgets = {"train": dict(eng.backend_kwargs),
               "eval": E.eval_backend_kwargs(params_ls, h, w, cfg["tpu"])}
    out = {}
    for name, bk in budgets.items():
        d = os.path.join(out_dir, name)
        with contextlib.redirect_stdout(io.StringIO()):
            E.eval_sequence(eng.dataset, params_ls, frames, d,
                            backend_kwargs=bk,
                            baseframe_every=cfg["baseframe_every"], **kw)
        out[name] = np.atleast_1d(np.loadtxt(os.path.join(d, "psnr.txt")))
    out["mpt"] = (budgets["train"]["max_pairs_per_tile"],
                  budgets["eval"]["max_pairs_per_tile"])
    return out


def drive(eng, cfg, frames, port, rec=None):
    """Frames 0..frames-1 through an engine; per frame the largest pairs
    per tile of its map at the committed pose (counted up to COUNT_CAP),
    the share of tiles that reach the pair budget, and the budget."""
    share, top, budget = [], [], []
    span = cfg["tpu"]["span_cap"]
    cam = TP.setup_camera(eng.cam.width, eng.cam.height,
                          np.asarray(eng.intrinsics)[:3, :3])
    for t in range(frames):
        if rec is not None:
            rec.t = t
        if t == 0 and not port:
            eng.process_frame_zero()
        else:
            eng.process_frame(t)
        mpt = dict(eng.backend_kwargs)["max_pairs_per_tile"]
        sec = eng.sections[0]
        c = tile_counts(sec.params, sec.n_active, np.asarray(eng.traj.quats[t]),
                        np.asarray(eng.traj.trans[t]), cam, span, COUNT_CAP)
        share.append(float((c >= mpt).mean()))
        top.append(int(c.max()))
        budget.append(mpt)
    return dict(share=share, max=top, budgets=budget)


def jax_run(cfg, frames, out_dir, nudge=None):
    t0 = time.time()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JI, "cv2", None)         # the numpy Canny, as the port
        if nudge is not None:
            one_ulp_frames(mp, *NUDGES[nudge])
        rec = _Recorder(mp)
        eng = JP.VTGaussianSLAM(cfg)
        per_frame = drive(eng, cfg, frames, False, rec)
        eng._page_cold_finish()
        res = scores(eng, JE, cfg, frames, out_dir)
    res.update(per_frame, densified=list(eng.num_gs_per_frame_ls),
               seconds=time.time() - t0)
    return res, rec


def port_run(cfg, frames, out_dir, rec, port_fault=None):
    t0 = time.time()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JI, "cv2", None)
        if port_fault is not None:
            port_fault(mp)
        eng = TP.VTGaussianSLAM(cfg, device="cpu", **rec.port_hooks())
        per_frame = drive(eng, cfg, frames, True)
        res = scores(eng, TE, cfg, frames, out_dir, device="cpu")
        eng.close()
    res.update(per_frame, densified=list(eng.num_gs_per_frame_ls),
               seconds=time.time() - t0)
    return res


def w2(runs):
    """default - generic per frame, at each budget."""
    return {b: runs["default"][b] - runs["generic"][b]
            for b in ("train", "eval")}


def fmt(xs, nd=2):
    return " / ".join(f"{x:.{nd}f}" for x in xs)


def routes_at(h, w, frames, iters, nudges, mpt, root, port_fault=None):
    """Both routes in both packages at one pair budget, and the JAX engine
    on the nudged frames: ({route: JAX run}, {route: port run},
    {nudge: {route: JAX run}}). port_fault(mp) patches the port's runs."""
    jax_s, port_s = {}, {}
    nudged = {n: {} for n in nudges}
    for route in ROUTES:
        cfg = w2_config(h, w, route == "generic", mpt, iters,
                        os.path.join(root, route))
        jax_s[route], rec = jax_run(cfg, frames,
                                    os.path.join(root, route, "jax"))
        port_s[route] = port_run(cfg, frames,
                                 os.path.join(root, route, "port"), rec,
                                 port_fault)
        for n in nudges:
            nudged[n][route], _ = jax_run(cfg, frames,
                                          os.path.join(root, route, n), n)
    return jax_s, port_s, nudged


def port_shares(jax_s, port_s, nudged):
    """The port against JAX on each yardstick: rows (name, the port's
    largest share, its tolerance) for each route's densify counts (port
    minus JAX against max(2 x JAX's one-ulp spread, 1% of the count, 5)) and
    for W2 at each budget (port minus JAX against max(2 x JAX's one-ulp
    spread of W2, 0.05 dB))."""
    rows = []
    for route in ROUTES:
        j = np.array(jax_s[route]["densified"])
        d = np.abs(np.array(port_s[route]["densified"]) - j)
        spread = np.max([np.abs(np.array(nudged[n][route]["densified"]) - j)
                         for n in nudged], axis=0)
        tol = np.maximum(np.maximum(SPREAD_K * spread, DENSIFY_SHARE * j),
                         DENSIFY_PIXEL)
        worst = int(np.argmax(d - tol))
        rows.append((f"{route} densify counts", float(d[worst]),
                     float(tol[worst])))
    ref, got = w2(jax_s), w2(port_s)
    for b in ("train", "eval"):
        spread = max(np.abs(w2(nudged[n])[b] - ref[b]).max() for n in nudged)
        rows.append((f"W2 at the {b} budget",
                     float(np.abs(got[b] - ref[b]).max()),
                     max(SPREAD_K * spread, FLOOR_DB)))
    return rows


def run_budget(tag, h, w, frames, iters, nudges, mpt, root):
    """`routes_at`, each run and the port's shares printed; returns (JAX
    runs, port runs, whether the port equals JAX on every yardstick)."""
    jax_s, port_s, nudged = routes_at(h, w, frames, iters, nudges, mpt, root)
    for route in ROUTES:
        for name, r in (("JAX", jax_s[route]), ("port", port_s[route]),
                        *((f"JAX {n} one ulp up", nudged[n][route])
                          for n in nudges)):
            print(f"[{tag} {route} {name}] {r['seconds']:.1f} s | "
                  f"budget per frame {r['budgets']}, final (training, eval) "
                  f"{r['mpt']} | PSNR per frame "
                  f"{fmt(r['eval'])} dB at the eval budget, "
                  f"{fmt(r['train'])} at the training budget | initial / "
                  f"densified {r['densified']} | tiles at the pair budget "
                  f"{fmt(r['share'], 4)}, pairs per tile max {r['max']}",
                  flush=True)
    ref, got = w2(jax_s), w2(port_s)
    for b in ("train", "eval"):
        print(f"[{tag}] W2 (default - generic) at the {b} budget: JAX "
              f"{fmt(ref[b])} dB, port {fmt(got[b])} dB")
    ok = True
    for name, part, tol in port_shares(jax_s, port_s, nudged):
        ok = ok and part <= tol
        print(f"[{tag}] {name}: the port's largest share {part:.4f} "
              f"(tolerance {tol:.4f})")
    return jax_s, port_s, ok


def trace_size(h, w, frames, iters, nudges, share, mpt, root):
    """W2 at the budget --share picks (D4), then at a budget no tile of any
    of those runs reaches (both routes then train on every pair)."""
    mpt = budget_for(h, w, iters, share, mpt)
    jax_s, port_s, ok = run_budget(f"{h}x{w} mpt {mpt}", h, w, frames, iters,
                                   nudges, mpt, os.path.join(root, "cut"))
    ref = w2(jax_s)
    dens = [jax_s[r]["densified"][1] for r in ROUTES]
    below = bool((ref["eval"][1:] > 0).all())
    sign = below and dens[1] >= 2 * dens[0]
    print(f"[{h}x{w}] D4: JAX shows the card's sign (generic below default "
          f"at the eval budget on frames 1-{frames - 1}: {below}; frame-1 "
          f"densify default {dens[0]}, generic {dens[1]}): {sign}; the port "
          f"equals JAX (W2 share and densify counts within tolerance): {ok} "
          f"-> W2 is the JAX package's own: {sign and ok}", flush=True)
    top = max(max(r["max"]) for r in (*jax_s.values(), *port_s.values()))
    cover = 1 << top.bit_length()
    jax_c, _, ok_c = run_budget(f"{h}x{w} mpt {cover}", h, w, frames, iters,
                                nudges, cover, os.path.join(root, "cover"))
    gap = w2(jax_c)["eval"]
    print(f"[{h}x{w}] at mpt {cover} (above every run's largest pair count "
          f"per tile, {top}): JAX default - generic {fmt(gap)} dB at the "
          f"eval budget (at mpt {mpt}: {fmt(ref['eval'])}); the port equals "
          f"JAX: {ok_c}", flush=True)


FIELDS5 = ("means3d", "rgb_colors", "unnorm_rotations", "logit_opacities",
           "log_scales")


def frame_one(h, w, iters, nudges, mpt, root):
    """The default route's frame 1, where the packages can part at a
    partial cut: the frame-1 pose (largest |d trans|) and densify count of
    the JAX engine on each nudge and of the port, each against the JAX
    engine's; then the port's frame 1 started from the JAX engine's
    frame-0 map, and the two packages' track caches built from that map at
    frame 0's pose (tiles whose counts, and whose slots, differ)."""
    cfg = w2_config(h, w, False, mpt, iters, root)

    def jax_two(nudge=None):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JI, "cv2", None)
            if nudge is not None:
                one_ulp_frames(mp, *NUDGES[nudge])
            rec = _Recorder(mp)
            eng = JP.VTGaussianSLAM(cfg)
            rec.t = 0
            eng.process_frame_zero()
            sec = eng.sections[0]
            bk = dict(eng.backend_kwargs)
            cache = JTC.build_track_cache(
                sec.params, sec.active_mask(), eng.traj.quats[0],
                eng.traj.trans[0], eng.cam, span_cap=bk["span_cap"],
                max_pairs_per_tile=bk["max_pairs_per_tile"],
                chunk=bk["chunk"], select=eng._bin_select)
            p0 = {f: np.array(getattr(sec.params, f)) for f in FIELDS5}
            rec.t = 1
            eng.process_frame(1)
        return eng, rec, p0, cache

    jeng, rec, p0, jcache = jax_two()
    ref = np.asarray(jeng.traj.trans[1])
    gap = lambda e: float(np.abs(np.asarray(e.traj.trans[1]) - ref).max())
    print(f"[{h}x{w} mpt {mpt} frame 1] JAX: densify "
          f"{jeng.num_gs_per_frame_ls[1]}", flush=True)
    for n in nudges:
        e = jax_two(n)[0]
        print(f"[{h}x{w} mpt {mpt} frame 1] JAX {n} one ulp up: pose "
              f"{gap(e) * 1e3:.3f} mm off, densify {e.num_gs_per_frame_ls[1]}",
              flush=True)
    for start in ("its own", "the JAX engine's"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JI, "cv2", None)
            eng = TP.VTGaussianSLAM(cfg, device="cpu", **rec.port_hooks())
            eng.process_frame(0)
            note = ""
            if start != "its own":
                s0 = eng.sections[0]
                params = s0.params.replace(**{
                    f: torch.as_tensor(p0[f]) for f in FIELDS5})
                eng.sections[0] = s0.replace(params=params)
                bk = eng.backend_kwargs
                tc = TTC.build_track_cache(
                    params, s0.active_mask(), eng.traj.quats[0],
                    eng.traj.trans[0], eng.cam, span_cap=bk["span_cap"],
                    max_pairs_per_tile=bk["max_pairs_per_tile"],
                    chunk=bk["chunk"], select=eng._bin_select)
                n = tc.counts.shape[0]
                jc = np.asarray(jcache.counts)[:n]
                js = np.asarray(jcache.slots8)[:n]
                d = np.abs(js - tc.slots8.numpy()).reshape(n, -1).max(1)
                note = (f"; track caches from that map: counts differ on "
                        f"{int((jc != tc.counts.numpy()).sum())} of {n} "
                        f"tiles, slots on {int((d > 0).sum())}")
            eng.process_frame(1)
            eng.close()
        print(f"[{h}x{w} mpt {mpt} frame 1] the port from {start} frame-0 "
              f"map: pose {gap(eng) * 1e3:.3f} mm off, densify "
              f"{eng.num_gs_per_frame_ls[1]}{note}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", default="96x176,170x300")
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--iters", default="20,25",
                    help="tracking, mapping iterations per frame")
    ap.add_argument("--nudges", default=",".join(NUDGES),
                    help=f"comma-separated, of {sorted(NUDGES)}")
    ap.add_argument("--share", type=float, default=0.97)
    ap.add_argument("--mpt", type=int, default=None,
                    help="the pair budget (default: from --share)")
    ap.add_argument("--frame-one", action="store_true",
                    help="only `frame_one` at each size (needs --mpt)")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    iters = tuple(int(x) for x in args.iters.split(","))
    nudges = [n for n in args.nudges.split(",") if n]
    root = tempfile.mkdtemp(prefix="trace_w2_")
    for size in args.sizes.split(","):
        h, w = (int(x) for x in size.split("x"))
        if args.frame_one:
            frame_one(h, w, iters, nudges, args.mpt, os.path.join(root, size))
        else:
            trace_size(h, w, args.frames, iters, nudges, args.share,
                       args.mpt, os.path.join(root, size))


if __name__ == "__main__":
    main()
