"""Seeding, device selection and persistence of params.

Parity: `vtgaussian_slam_tpu/utils/common.py` (seed_everything,
save_params, save_params_ckpt). The port keeps explicit `torch.Generator`s
for every random draw; the global seeds here only cover host-side
numpy/python choices.
"""
from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int = 42) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    print(f"Seed set to: {seed} (type: {type(seed)})")


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. CUDA unless the caller asks for
    the CPU; a missing card is an error, never a silent CPU run."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels")
    return dev


def save_params(output_params_ls: list, output_dir: str,
                name: str = "params_ls.npy") -> str:
    """Save the list of per-section params dicts (reference format: one
    object array, loaded back with `np.load(..., allow_pickle=True)`)."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, name)
    np.save(path, np.array(output_params_ls, dtype=object), allow_pickle=True)
    return path


def save_params_ckpt(params: dict, output_dir: str, time_idx: int) -> str:
    """Emergency dump of one params dict as `params<t>.npz`."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f"params{time_idx}.npz")
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})
    return path
