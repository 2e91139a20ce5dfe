"""Convert a torch LPIPS checkpoint (.pth/.pt state dict) to the .npz
format `eval/lpips.py` loads.

The port's own copy of `vtgaussian_slam_tpu/eval/lpips_convert.py`. No
pretrained weights ship with the repository, so they are supplied as a
file; this tool accepts the state dicts of

  - the `lpips` package (richzhang/PerceptualSimilarity):
    keys `net.slice{1..5}.{idx}.weight/bias`, `lin{0..4}.model.1.weight`
  - torchmetrics' `LearnedPerceptualImagePatchSimilarity` (the same keys
    under a `net.` / `lpips.` wrapper prefix)

and writes a flat .npz with the torch names kept (wrapper prefixes
removed), which `lpips.load_lpips_weights` / `VTGS_LPIPS_WEIGHTS` read.

Usage:
    python -m vtgaussian_slam_tpu_torch.eval.lpips_convert lpips_alex.pth out.npz
"""
from __future__ import annotations

import sys

import numpy as np

_WRAPPER_PREFIXES = ("lpips.", "model.", "module.")


def convert_state_dict(state: dict) -> dict:
    """Torch state dict -> {name: float32 ndarray} with wrapper prefixes
    stripped and only conv/linear tensors kept."""
    names = {}
    for k in state:
        name = k
        for p in _WRAPPER_PREFIXES:
            if name.startswith(p):
                name = name[len(p):]
        names[k] = name
    # torchmetrics' LearnedPerceptualImagePatchSimilarity holds the whole
    # lpips module as its `net` attribute, so its state dict double-wraps:
    # net.net.slice*, net.lin{i}.model.1.weight, net.scaling_layer.* (plus
    # metric-state buffers sum_scores/total). Unwrap that extra level so
    # the names match the `lpips` package layout.
    if any(n.startswith("net.net.slice") for n in names.values()):
        names = {k: (n[len("net."):] if n.startswith("net.") else n)
                 for k, n in names.items()}
    out = {}
    for k, v in state.items():
        name = names[k]
        if not (name.startswith("net.slice") or name.startswith("lin")):
            continue
        arr = np.asarray(
            v.detach().cpu().numpy() if hasattr(v, "detach") else v,
            dtype=np.float32)
        out[name] = arr
    return out


def convert(pth_path: str, npz_path: str) -> dict:
    import torch

    try:
        state = torch.load(pth_path, map_location="cpu", weights_only=True)
    except Exception:
        # a pickled full module (torch.save(model, ...)) cannot load under
        # weights_only — retry unrestricted, then unwrap
        state = torch.load(pth_path, map_location="cpu", weights_only=False)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    if "state_dict" in state and isinstance(state["state_dict"], dict):
        state = state["state_dict"]
    out = convert_state_dict(state)
    if not out:
        raise ValueError(
            f"no LPIPS tensors (net.*/lin*) found in {pth_path}; "
            f"keys were: {list(state)[:10]}...")
    np.savez(npz_path, **out)
    return out


if __name__ == "__main__":
    if len(sys.argv) != 3:
        print(__doc__)
        sys.exit(2)
    out = convert(sys.argv[1], sys.argv[2])
    print(f"wrote {len(out)} tensors to {sys.argv[2]}")
