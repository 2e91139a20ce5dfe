"""Command line: run the first section of online SLAM through the port.

    python -m vtgaussian_slam_tpu_torch <config.py> [--frames N] [--device cuda|cpu]
        [--set KEY=VALUE ...]

Loads a scene config module (the JAX package's schema, `configs/`), applies
the `--set` overrides (a dotted key into the config dict and a Python
literal, e.g. `--set tpu.track_cache=False` for the generic tracking
route), runs
frames 0 .. min(N, baseframe_every) - 1 (frame 0 seeds and maps the section;
every later frame tracks, densifies and maps), and prints per frame the
phase wall times, the Gaussian count, and the PSNR / depth L1 of a render at
the committed pose, then the Horn-aligned ATE. Section boundaries arrive in
a later port slice.
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
                    help="frames to run (capped at baseframe_every)")
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
    n = min(args.frames or engine.num_frames, engine.num_frames, engine.bfe)
    for t in range(n):
        engine.process_frame(t)
        ft = engine.frame_times[t]
        psnr, l1 = engine.evaluate_frame(t)
        print(f"frame {t}: track {ft['track']:.3f} s densify "
              f"{ft['densify']:.3f} s map {ft['map']:.3f} s | n_active "
              f"{engine.sections[0].n_active} | PSNR {psnr:.2f} dB | depth L1 "
              f"{l1 * 100:.2f} cm", flush=True)
    print(f"ATE: {engine.ate(n) * 100:.3f} cm over {n} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
