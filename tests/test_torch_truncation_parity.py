"""Depth-prefix truncation: the port loses what the JAX package loses.

Every tiled render (`tiled.render_tiled`, on both sides) keeps each tile's
first `max_pairs_per_tile` pairs by depth. Two quality gaps on the card
come from that cut: the generic route (track_cache / map_binned off) maps
the room0 proxy to lower PSNR than the default binned routes (ROADMAP W2),
and the CLI's eval at the training budget scores dense maps far below the
eval_mode budget (W6). This test measures both on each side and holds the
port's share of them.

Config: test_torch_slice's replica-style proxy at 48 x 64 (3 x 4 tiles)
with a 2x densification stream, 3 frames of 4 iterations, and the pair
budget cut to 384: the final maps hold ~1.95x the budget in pairs per tile
on average (up to ~4.5x), the room0 proxy's ratio (~1040 pairs per tile at
mpt 512). The budget is cut, not the map grown.

Both packages run the binned and the generic route; the port gets the JAX
engine's keyframe draws (test_torch_slice.slice_draws). Each map is scored
by `eval_sequence`, per frame PSNR, at the training budget (what the CLI
renders at) and at `eval_backend_kwargs`' budget (what eval_mode renders
at):
- W2: binned - generic, per frame, at each budget;
- W6: eval_mode budget - training budget, per frame, for each route's map.
The port's share of each is its value minus JAX's. It is held within the
larger of 0.05 dB and twice the JAX engine's own spread: the largest change
of the same quantity over JAX runs on frames one ulp off (the three nudges
of torch_port_util.jax_spread). The floor lies well below the smallest
|W2| measured here (0.24 dB at the training budget), so a port whose two
routes scored alike would fail. test_torch_parity_controls.py holds a
wrong prefix cut (the last pairs by depth) against this check.

This proxy has 12 tiles, under the 64 at which `auto_pair_budget` divides
by 12, and does not show the card's W2 sign at the training budget. The
66-tile case (tests/trace_w2_scale.py's room0 proxy at 96 x 176, 2
frames of 4 iterations, mpt 384, every tile cut) does: there JAX's
generic route scores >= 1 dB below its default route at the eval budget
on every frame, and the port's share of W2 and of the densify counts is
held on the same yardsticks (`trace_w2_scale.port_shares`)."""
import os

import numpy as np
import pytest
import torch

import trace_w2_scale as TW
from test_torch_slice import FRAMES, _config, slice_draws
from torch_port_util import NUDGES, one_thread, one_ulp_frames  # noqa: F401
from vtgaussian_slam_tpu.core import pipeline as JP
from vtgaussian_slam_tpu.eval import evaluate as JE
from vtgaussian_slam_tpu.ops import image as JI
from vtgaussian_slam_tpu_torch.core import pipeline as TP
from vtgaussian_slam_tpu_torch.eval import evaluate as TE
from vtgaussian_slam_tpu_torch.ops import geometry as geo
from vtgaussian_slam_tpu_torch.ops.rasterizer.binning import bin_gaussians
from vtgaussian_slam_tpu_torch.ops.rasterizer.projection import \
    project_gaussians

H, W = 48, 64
MPT = 384
SPREAD_K = 2.0
FLOOR_DB = 0.05


def _truncation_config(workdir, generic: bool) -> dict:
    cfg = _config(workdir)
    cfg["data"]["synthetic"].update(height=H, width=W)
    cfg["data"].update(desired_image_height=H, desired_image_width=W,
                       densification_image_height=2 * H,
                       densification_image_width=2 * W)
    cfg["tpu"]["max_pairs_per_tile"] = MPT
    if generic:
        cfg["tpu"].update(track_cache=False, map_binned=False)
    return cfg


def _scores(eng, E, cfg, out_dir, **kw) -> dict:
    """Per-frame PSNR of an engine's map at the training budget and at
    eval_backend_kwargs' budget, through its package's eval_sequence."""
    params_ls = eng.export_params_ls()
    budgets = {"train": dict(eng.backend_kwargs),
               "eval": E.eval_backend_kwargs(params_ls, H, W, cfg["tpu"])}
    out = {}
    for name, bk in budgets.items():
        d = os.path.join(out_dir, name)
        E.eval_sequence(eng.dataset, params_ls, FRAMES, d, backend_kwargs=bk,
                        baseframe_every=cfg["baseframe_every"], **kw)
        out[name] = np.loadtxt(os.path.join(d, "psnr.txt"))
    out["mpt"] = (budgets["train"]["max_pairs_per_tile"],
                  budgets["eval"]["max_pairs_per_tile"])
    return out


def _jax_scores(cfg, out_dir, nudge=None) -> dict:
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JI, "cv2", None)          # the numpy Canny, as the port
        if nudge is not None:
            one_ulp_frames(mp, *NUDGES[nudge])
        eng = JP.VTGaussianSLAM(cfg)
        eng.process_frame_zero()
        for t in range(1, FRAMES):
            eng.process_frame(t)
        return _scores(eng, JE, cfg, out_dir)


def _pairs_per_tile(eng) -> np.ndarray:
    """Pairs per tile of a port engine's map at its last pose, uncut."""
    sec = eng.sections[0]
    p = sec.params
    w2c = geo.pose_to_w2c(geo.normalize(eng.traj.quats[FRAMES - 1]),
                          eng.traj.trans[FRAMES - 1])
    proj = project_gaussians(geo.transform_points(w2c, p.means3d),
                             p.unnorm_rotations, torch.exp(p.log_scales),
                             torch.sigmoid(p.logit_opacities[:, 0]), eng.cam,
                             sec.active_mask())
    span = eng.config["tpu"]["span_cap"]
    return bin_gaussians(proj, 16, span, (W + 15) // 16, (H + 15) // 16,
                         1 << 14).counts.numpy()


def _losses(s) -> dict:
    """W2 and W6 per frame from {route: scores}, for the routes that ran."""
    out = {}
    if "binned" in s and "generic" in s:
        b, g = s["binned"], s["generic"]
        out.update({"W2 train": b["train"] - g["train"],
                    "W2 eval": b["eval"] - g["eval"]})
    for route, r in s.items():
        out[f"W6 {route}"] = r["eval"] - r["train"]
    return out


def run_routes(root, routes=("binned", "generic"), port_fault=None):
    """Both packages on each route, JAX also on the one-ulp frames:
    (jax scores, port scores, nudged JAX scores, port pairs per tile / MPT),
    each by route. port_fault(mp) patches the port's run and scoring."""
    jax_s, port_s, ratio = {}, {}, {}
    nudged = {n: {} for n in NUDGES}
    for route in routes:
        cfg = _truncation_config(root / route, route == "generic")
        jax_s[route] = _jax_scores(cfg, str(root / route / "jax"))
        for n in NUDGES:
            nudged[n][route] = _jax_scores(cfg, str(root / route / n), n)
        draws = slice_draws(cfg)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JI, "cv2", None)
            if port_fault is not None:
                port_fault(mp)
            eng = TP.VTGaussianSLAM(cfg, device="cpu",
                                    map_draws=lambda t, n, c: draws[t][:n])
            for t in range(FRAMES):
                eng.process_frame(t)
            ratio[route] = _pairs_per_tile(eng) / MPT
            port_s[route] = _scores(eng, TE, cfg, str(root / route / "port"),
                                    device="cpu")
    return jax_s, port_s, nudged, ratio


def assert_port_shares(jax_s, port_s, nudged) -> None:
    """The port's share of each loss (its value minus JAX's, per frame)
    within max(SPREAD_K x the JAX engine's one-ulp spread, FLOOR_DB)."""
    ref, got = _losses(jax_s), _losses(port_s)
    for name in ref:
        spread = max(np.abs(_losses(nudged[n])[name] - ref[name]).max()
                     for n in NUDGES)
        tol = max(SPREAD_K * spread, FLOOR_DB)
        share = got[name] - ref[name]
        print(f"{name}: JAX {np.round(ref[name], 4)} dB, port "
              f"{np.round(got[name], 4)} dB, port share "
              f"{np.abs(share).max():.2e} dB, JAX one-ulp spread "
              f"{spread:.4f} dB, tolerance {tol:.4f} dB")
        assert np.abs(share).max() <= tol, (name, share, tol)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_routes(tmp_path_factory.mktemp("truncation"))


def test_the_budget_is_cut_to_the_proxys_ratio(runs):
    jax_s, port_s, _, ratio = runs
    for route, r in ratio.items():
        print(f"{route}: pairs per tile / mpt {MPT}: mean {r.mean():.3f}, "
              f"max {r.max():.3f}, min {r.min():.3f}; budgets (training, "
              f"eval_mode) {port_s[route]['mpt']}")
        assert 1.5 <= r.mean() <= 2.5, (route, r.mean())
        assert port_s[route]["mpt"] == jax_s[route]["mpt"]
        assert port_s[route]["mpt"][0] == MPT < port_s[route]["mpt"][1]


def test_port_truncation_losses_match_jax(runs):
    jax_s, port_s, nudged, _ = runs
    assert_port_shares(jax_s, port_s, nudged)
    ref = _losses(jax_s)
    # the cut bites: the training budget loses several dB on both maps
    for name in ("W6 binned", "W6 generic"):
        assert ref[name].min() > 3.0, (name, ref[name])


SCALE = dict(h=96, w=176, frames=2, iters=(4, 4), mpt=384)


def run_scale(root, port_fault=None):
    """trace_w2_scale's 66-tile case: both routes in both packages, the
    JAX engine also on the three one-ulp nudges."""
    return TW.routes_at(SCALE["h"], SCALE["w"], SCALE["frames"],
                        SCALE["iters"], list(NUDGES), SCALE["mpt"], str(root),
                        port_fault)


def assert_scale_shares(jax_s, port_s, nudged) -> None:
    """Every row of `trace_w2_scale.port_shares` within its tolerance; the
    failure names each row that is not."""
    rows = TW.port_shares(jax_s, port_s, nudged)
    for name, part, tol in rows:
        print(f"{name}: the port's largest share {part:.4f}, tolerance "
              f"{tol:.4f}")
    bad = [name for name, part, tol in rows if part > tol]
    assert not bad, f"outside the JAX package's spread: {bad}"


def test_route_gap_at_66_tiles_matches_jax(tmp_path):
    jax_s, port_s, nudged = run_scale(tmp_path)
    gap = TW.w2(jax_s)["eval"]
    print(f"JAX W2 at the eval budget {np.round(gap, 4)} dB, port "
          f"{np.round(TW.w2(port_s)['eval'], 4)} dB; tiles at the pair "
          f"budget {[jax_s[r]['share'] for r in TW.ROUTES]}")
    # the card's sign: every tile cut, the generic route >= 1 dB below
    assert gap.min() >= 1.0, gap
    assert min(min(jax_s[r]["share"]) for r in TW.ROUTES) == 1.0
    assert_scale_shares(jax_s, port_s, nudged)
