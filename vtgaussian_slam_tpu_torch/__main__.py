"""Command line: run online SLAM through the port, save and score the map.

    python -m vtgaussian_slam_tpu_torch <config.py> [--frames N] [--device cuda|cpu]
        [--set KEY=VALUE ...]

The contract of the JAX package's `src/vtgaussian_slam.py`: loads a scene
config module (`configs/`), applies the `--set` overrides (a dotted key
into the config dict and a Python literal, e.g. `--set
tpu.track_cache=False` for the generic tracking route or `--set
eval_mode=True`), seeds, and writes into `workdir/run_name/`: a copy of
the config file, `params_ls.npy` (one reference-format dict per section)
and `eval/` (psnr / rmse / l1 / ssim / lpips .txt per evaluated frame, the
rendered and ground-truth frames as PNGs, metrics.png with matplotlib).

A SLAM run prints per frame the section it tracked against, the phase wall
times, the Gaussian count and the PSNR / depth L1 of a render at the
committed pose, then the ATE, the final statistics and the evaluation's
averages, ending with "Final Average ATE RMSE". With `--frames N` it runs
and evaluates frames 0 .. N - 1. With `eval_mode` it re-scores the results
directory's saved `params_ls.npy` instead, at a pair budget sized from the
map (the training budget is not saved).
"""
from __future__ import annotations

import argparse
import ast
import importlib.util
import os
import shutil
import sys
import time

import numpy as np


def apply_override(config: dict, item: str) -> None:
    """config["a"]["b"] = literal for the item "a.b=literal".

    A value that is no Python literal is kept as a bare string (a path, a
    name) only for a key that is new or holds a string now; "false" and
    the like, or a bare word for a flag or a number, raise, so a typo
    cannot turn a route on."""
    key, sep, value = item.partition("=")
    if not sep:
        raise SystemExit(f"--set takes KEY=VALUE, got {item!r}")
    *path, last = key.split(".")
    node = config
    for k in path:
        node = node.setdefault(k, {})
    try:
        node[last] = ast.literal_eval(value)
        return
    except (ValueError, SyntaxError):
        pass
    current = node.get(last)
    if (value.strip().lower() in ("true", "false", "none", "null")
            or not (current is None or isinstance(current, str))):
        raise SystemExit(
            f"--set {key}: {value!r} is not a Python literal (write True, "
            f"False, None or a number; a bare string only for a string key)")
    node[last] = value


def _lpips_scorer(device):
    from .eval.lpips import lpips_fn
    lpips = lpips_fn(device=device)
    if lpips is None and os.environ.get("VTGS_LPIPS_WEIGHTS"):
        print("WARNING: VTGS_LPIPS_WEIGHTS set but weights failed to load; "
              "LPIPS will be NaN")
    elif lpips is not None and lpips.source == "untrained-fallback":
        print("NOTE: LPIPS uses the untrained-backbone fallback (no "
              "VTGS_LPIPS_WEIGHTS supplied); values are self-consistent but "
              "not comparable to pretrained-AlexNet LPIPS")
    return lpips


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vtgaussian_slam_tpu_torch")
    ap.add_argument("config", help="scene config module (configs/...)")
    ap.add_argument("--frames", type=int, default=None,
                    help="frames to run and evaluate (default: the whole "
                         "sequence)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override a config entry, e.g. tpu.track_cache=False")
    args = ap.parse_args(argv)

    sys.path.insert(0, os.getcwd())
    spec = importlib.util.spec_from_file_location("scene_config", args.config)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    config = module.config
    for item in args.set:
        apply_override(config, item)

    from .core.config import prepare_config
    from .eval.evaluate import eval_backend_kwargs, eval_sequence
    from .utils.common import resolve_device, seed_everything

    device = resolve_device(args.device)
    seed_everything(seed=config["seed"])
    results_dir = os.path.join(config["workdir"], config["run_name"])
    if not config.get("load_checkpoint", False):
        os.makedirs(results_dir, exist_ok=True)
        dst = os.path.join(results_dir, "config.py")
        # eval_mode often re-runs the results directory's own config.py:
        # copying a file onto itself raises SameFileError
        if not (os.path.exists(dst) and os.path.samefile(args.config, dst)):
            shutil.copy(args.config, dst)

    config = prepare_config(config)
    eval_dir = os.path.join(results_dir, "eval")
    os.makedirs(eval_dir, exist_ok=True)
    lpips = _lpips_scorer(device)
    eval_kw = dict(
        sil_thres=config["mapping"]["sil_thres"],
        mapping_iters=config["mapping"]["num_iters"],
        add_new_gaussians=config["mapping"]["add_new_gaussians"],
        eval_every=config["eval_every"],
        baseframe_every=config["baseframe_every"], save_frames=True,
        lpips_fn=lpips, device=device)

    if config["eval_mode"]:
        from .core.pipeline import build_dataset
        dataset = build_dataset(config)
        num_frames = config["data"].get("num_frames", -1)
        if num_frames == -1:
            num_frames = len(dataset)
        if args.frames:
            num_frames = min(num_frames, args.frames)
        params_ls = list(np.load(os.path.join(results_dir, "params_ls.npy"),
                                 allow_pickle=True))
        color0 = dataset[0][0]
        # the training budget is not saved: render at a budget sized from
        # the map, so trained blend depth is not truncated
        eval_sequence(dataset, params_ls, num_frames, eval_dir,
                      backend_kwargs=eval_backend_kwargs(
                          params_ls, color0.shape[0], color0.shape[1],
                          config.get("tpu")), **eval_kw)
        return 0

    from .core.pipeline import VTGaussianSLAM
    t0 = time.time()
    engine = VTGaussianSLAM(config, device=device)
    print(f"init: {time.time() - t0:.2f} s, {engine.sections[0].n_active} "
          f"gaussians, {engine.cam.height}x{engine.cam.width}")
    n = min(args.frames or engine.num_frames, engine.num_frames)

    def report(t):
        ft = engine.frame_times[t]
        psnr, l1 = engine.evaluate_frame(t)
        sec = engine.sections[t // engine.bfe]
        print(f"frame {t}: section {engine.section_ids[t]} | track "
              f"{ft['track']:.3f} s spawn {ft['spawn']:.3f} s densify "
              f"{ft['densify']:.3f} s map {ft['map']:.3f} s | n_active "
              f"{sec.n_active} | PSNR {psnr:.2f} dB | depth L1 "
              f"{l1 * 100:.2f} cm", flush=True)

    try:
        engine.run(n, on_frame=report)
        print(f"ATE: {engine.ate(n) * 100:.3f} cm over {n} frames")
        stats = engine.final_stats()
        print(f"\nAverage Tracking/Iteration Time: "
              f"{stats['avg_tracking_iter_ms']} ms")
        print(f"Average Tracking/Frame Time: {stats['avg_tracking_frame_s']} s")
        print(f"Average Mapping/Iteration Time: "
              f"{stats['avg_mapping_iter_ms']} ms")
        print(f"Average Mapping/Frame Time: {stats['avg_mapping_frame_s']} s")
        print(f"Number of Gaussians: {stats['num_gaussians']} in "
              f"{stats['num_sections']} sections")
        print("Max tile pair-budget truncation:",
              f"{stats['tile_truncation_frac_max']:.3f}",
              "(near 1.0 -> raise tpu.max_pairs_per_tile)")
        print(f"Section paging: {stats['section_page_outs']} out, "
              f"{stats['section_page_ins']} in")

        params_ls = engine.export_params_ls()
        np.save(os.path.join(results_dir, "params_ls.npy"),
                np.array(params_ls, dtype=object), allow_pickle=True)
        # evaluate at the budget the map was trained with: a smaller one
        # truncates trained blend depth and under-reports quality
        eval_sequence(engine.dataset, params_ls, n, eval_dir,
                      backend_kwargs=dict(engine.backend_kwargs), **eval_kw)
    finally:
        engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
