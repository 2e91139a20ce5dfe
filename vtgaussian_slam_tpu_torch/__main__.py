"""Command line: run online SLAM through the port.

    python -m vtgaussian_slam_tpu_torch <config.py> [--frames N] [--device cuda|cpu]
        [--set KEY=VALUE ...]

Loads a scene config module (the JAX package's schema, `configs/`), applies
the `--set` overrides (a dotted key into the config dict and a Python
literal, e.g. `--set tpu.track_cache=False` for the generic tracking
route), runs frames 0 .. N - 1 across section boundaries (frame 0 seeds
and maps the first section; every later frame tracks, densifies and maps;
every baseframe_every-th frame selects, tracks against and spawns a
section), and prints per frame the section it tracked against, the phase
wall times, the Gaussian count, and the PSNR / depth L1 of a render at the
committed pose, then the Horn-aligned ATE and the run's final statistics.
"""
from __future__ import annotations

import argparse
import ast
import importlib.util
import os
import sys
import time


def apply_override(config: dict, item: str) -> None:
    """config["a"]["b"] = literal for the item "a.b=literal"."""
    key, sep, value = item.partition("=")
    if not sep:
        raise SystemExit(f"--set takes KEY=VALUE, got {item!r}")
    *path, last = key.split(".")
    node = config
    for k in path:
        node = node.setdefault(k, {})
    node[last] = ast.literal_eval(value)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vtgaussian_slam_tpu_torch")
    ap.add_argument("config", help="scene config module (configs/...)")
    ap.add_argument("--frames", type=int, default=None,
                    help="frames to run (default: the whole sequence)")
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

    from .core.pipeline import VTGaussianSLAM
    from .utils.common import seed_everything

    seed_everything(int(config.get("seed", 0)))
    t0 = time.time()
    engine = VTGaussianSLAM(config, device=args.device)
    print(f"init: {time.time() - t0:.2f} s, {engine.sections[0].n_active} "
          f"gaussians, {engine.cam.height}x{engine.cam.width}")
    n = min(args.frames or engine.num_frames, engine.num_frames)
    for t in range(n):
        engine.process_frame(t)
        ft = engine.frame_times[t]
        psnr, l1 = engine.evaluate_frame(t)
        sec = engine.sections[t // engine.bfe]
        print(f"frame {t}: section {engine.section_ids[t]} | track "
              f"{ft['track']:.3f} s spawn {ft['spawn']:.3f} s densify "
              f"{ft['densify']:.3f} s map {ft['map']:.3f} s | n_active "
              f"{sec.n_active} | PSNR {psnr:.2f} dB | depth L1 "
              f"{l1 * 100:.2f} cm", flush=True)
    engine._page_cold_finish()
    print(f"ATE: {engine.ate(n) * 100:.3f} cm over {n} frames")
    stats = engine.final_stats()
    print(f"Average Tracking/Iteration Time: {stats['avg_tracking_iter_ms']} ms")
    print(f"Average Tracking/Frame Time: {stats['avg_tracking_frame_s']} s")
    print(f"Average Mapping/Iteration Time: {stats['avg_mapping_iter_ms']} ms")
    print(f"Average Mapping/Frame Time: {stats['avg_mapping_frame_s']} s")
    print(f"Number of Gaussians: {stats['num_gaussians']} in "
          f"{stats['num_sections']} sections")
    print("Max tile pair-budget truncation:",
          f"{stats['tile_truncation_frac_max']:.3f}",
          "(near 1.0 -> raise tpu.max_pairs_per_tile)")
    print(f"Section paging: {stats['section_page_outs']} out, "
          f"{stats['section_page_ins']} in")
    return 0


if __name__ == "__main__":
    sys.exit(main())
