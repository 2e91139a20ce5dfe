"""A cell of the benchmark cut to a size a CPU test can run: the same
configuration and mix at 24 x 32 pixels, four tracking and mapping
iterations, sections of three frames in every scene family, a fixed
pair budget, 16 frames.
The port runs its plain PyTorch versions of the kernels there."""
from __future__ import annotations

import copy
import dataclasses

from portbench.harness.spec import load_cell

H, W = 24, 32
SEED = 14          # check_frames draws frame 2 for it: frames 2 and 3


def tiny_cell(name: str, root: str | None = None):
    cell = load_cell(name, root) if root else load_cell(name)
    cfg = copy.deepcopy(cell.config)
    cam = cfg["camera"]
    s = W / cam["image_width"]
    cam.update(image_height=H, image_width=W, fx=cam["fx"] * s,
               fy=cam["fy"] * s, cx=(cam["cx"] + 0.5) * s - 0.5,
               cy=(cam["cy"] + 0.5) * H / cam["image_height"] - 0.5)
    c = cfg["config"]
    c["data"].update(desired_image_height=H, desired_image_width=W,
                     densification_image_height=2 * H,
                     densification_image_width=2 * W)
    c["tracking"].update(num_iters=4, base1_num_iters=4)
    c["mapping"]["num_iters"] = 4
    c["baseframe_every"] = 3        # a boundary at frame 3
    if c.get("overlap_every"):      # TUM's selection needs at least one
        c["overlap_every"] = 1      # overlap frame a section
    c.setdefault("tpu", {}).update(map_binned=True, max_pairs_per_tile=128,
                                   auto_pair_budget=False)
    return dataclasses.replace(cell, config=cfg,
                               traffic=dict(cell.traffic, frames=16))


def run_tiny(name: str, tmp_path, root: str | None = None, trace=False,
             min_frames: int = 2, seed: int = SEED, readings: bool = False):
    import io
    from portbench.harness.session import run_cell
    kw = {"root": root} if root else {}
    return run_cell(tiny_cell(name, root), seed, 0.0, trace, device="cpu",
                    cache_root=str(tmp_path), min_frames=min_frames,
                    check_from=2,
                    readings=readings, log=io.StringIO(), **kw)
