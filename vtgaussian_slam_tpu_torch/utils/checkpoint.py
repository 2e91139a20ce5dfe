"""Checkpoint and resume of a SLAM run.

Parity: `vtgaussian_slam_tpu/utils/checkpoint.py`, key for key: one
`<run>/checkpoints/ckpt_<t>.npz` per checkpoint with the per-section
params (reference format, cropped to n_active), timesteps and scene radii,
the trajectory (`traj_*`), `gt_w2c`, the base-frame pool, the mapping ring
(`ring_*`) and `meta_json` (the correspondence lists, fixed_section_ids,
the far-depth statistics, the ScanNet++ probe losses, the pair budget's
boost / readings / cadence counter, the timing statistics). The port's
own random streams, its two `torch.Generator`s, go under keys of their
own (`torch_map_generator`, `torch_select_generator`), and its statistics
carry the JAX package's names beside its own, so each package loads the
other's files; the port draws no numpy randomness (`np_rng_state` null)
and has no use for JAX's `jax_rng_key`.

The write is atomic (`.tmp.npz`, then `os.replace`); a load falls back to
older files when the newest does not read. A section paged out to pinned
host memory is saved from `host_section`, which waits for its copy to
land. On load, what the port keeps beyond the file is rebuilt from the
restored state: the mapping cache store knows the current section's
keyframe poses again (its caches are rebuilt on the next mapping phase),
the global binning is rebuilt, every section starts on the device and the
cold ones page out as after a frame, and the depth LRU refills from the
dataset. A truncation-probe reading in flight at the save is dropped, as
the JAX package drops it: a resumed run equals the uninterrupted one to
the bit only where no reading is in flight at the save frame (and, on the
binned mapping route, where the next frame starts a section, since the
uninterrupted run's older keyframe caches were built from older fields).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

# the JAX engine's names for the port's timing sums (its final_stats reads
# them after a resume)
_JAX_STAT_ALIASES = {
    "tracking_jit_time_sum": "tracking_loop_time_sum",
    "tracking_jit_iters": "tracking_loop_iters",
    "mapping_jit_time_sum": "mapping_loop_time_sum",
    "mapping_jit_iters": "mapping_loop_iters",
}
# the JAX engine's stats that the port does not keep, written as 0 so that
# a JAX engine resumed from the port's file finds every key it adds to
# (its averages of these then cover the frames it ran itself)
_JAX_ONLY_STATS = ("t_densify_fetch", "t_densify_host", "t_stage_ahead",
                   "tracking_iter_time_sum", "tracking_iter_count",
                   "mapping_iter_time_sum", "mapping_iter_count")


def checkpoint_dir(config: dict) -> str:
    return os.path.join(config["workdir"], config["run_name"], "checkpoints")


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def save_checkpoint(engine, time_idx: int) -> str:
    """Write the engine's state after frame `time_idx`; returns the path."""
    out_dir = checkpoint_dir(engine.config)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"ckpt_{time_idx:06d}.npz")

    blobs = {}
    for i in range(len(engine.sections)):
        sec = (engine.host_section(i) if i in engine.paged_sections()
               else engine.sections[i])
        n = sec.n_active
        p = sec.params
        blobs[f"sec{i}_means3D"] = _np(p.means3d[:n])
        blobs[f"sec{i}_rgb_colors"] = _np(p.rgb_colors[:n])
        blobs[f"sec{i}_unnorm_rotations"] = _np(p.unnorm_rotations[:n])
        blobs[f"sec{i}_logit_opacities"] = _np(p.logit_opacities[:n])
        blobs[f"sec{i}_log_scales"] = _np(p.log_scales[:n])
        blobs[f"sec{i}_timestep"] = _np(sec.vars.timestep[:n])
        blobs[f"sec{i}_scene_radius"] = np.asarray(sec.vars.scene_radius)
    blobs["traj_quats"] = _np(engine.traj.quats)
    blobs["traj_trans"] = _np(engine.traj.trans)
    blobs["gt_w2c"] = np.stack(engine.gt_w2c)
    bs = engine.baseframes
    nb = len(bs)
    blobs["baseframe_depths"] = _np(bs.depths[:nb])
    blobs["baseframe_quats"] = _np(bs.quats[:nb])
    blobs["baseframe_trans"] = _np(bs.trans[:nb])
    blobs["ring_colors"] = _np(engine.ring_colors)
    blobs["ring_depths"] = _np(engine.ring_depths)
    blobs["torch_map_generator"] = engine.map_generator.get_state().numpy()
    blobs["torch_select_generator"] = \
        engine.select_generator.get_state().numpy()
    stats = dict(engine.stats)
    for jax_name, name in _JAX_STAT_ALIASES.items():
        stats[jax_name] = stats[name]
    for k in _JAX_ONLY_STATS:
        stats.setdefault(k, 0.0)
    meta = {
        "time_idx": time_idx,
        "n_sections": len(engine.sections),
        "baseframe_ids": list(bs.ids),
        "baseframe_depth_stride": bs.stride,
        "tracking_corr": engine.tracking_corr,
        "earliest_corr": [[int(x) if isinstance(x, (int, np.integer)) else x
                           for x in row] for row in engine.earliest_corr],
        "mapping_corr": engine.mapping_corr,
        "fixed_section_ids": (list(engine.fixed_section_ids)
                              if engine.fixed_section_ids else None),
        "depth_means": engine.depth_means,
        "num_gs_per_frame_ls": list(engine.num_gs_per_frame_ls),
        "stats": stats,
        "frame_color_loss": engine.frame_color_loss,
        "frame_depth_loss": engine.frame_depth_loss,
        "mpt_boost": engine._mpt_boost,
        "harm_hist": list(engine._harm_hist),
        "frames_tracked": engine._frames_tracked,
        "np_rng_state": None,
        "section_ids": {str(k): int(v) for k, v in engine.section_ids.items()},
    }
    blobs["meta_json"] = np.frombuffer(
        json.dumps(meta, default=str).encode(), dtype=np.uint8)
    # atomic: a crash mid-save must not leave a truncated file that the
    # next resume would pick as the newest
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **blobs)
    os.replace(tmp, path)
    return path


def _read(path: str):
    data = np.load(path, allow_pickle=False)
    return data, json.loads(bytes(data["meta_json"]).decode())


def read_checkpoint(config: dict, path: str | None = None,
                    time_idx: int | None = None):
    """(arrays, meta) of the given file, or of the newest readable
    checkpoint of the run (the one at `time_idx` when given)."""
    if path is not None:
        return _read(path)
    ckpt_dir = checkpoint_dir(config)
    cands = sorted(os.listdir(ckpt_dir)) if os.path.isdir(ckpt_dir) else []
    if time_idx is not None:
        cands = [c for c in cands if c == f"ckpt_{time_idx:06d}.npz"]
    cands = [c for c in cands if not c.endswith(".tmp.npz")]
    if not cands:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    for c in reversed(cands):
        try:
            return _read(os.path.join(ckpt_dir, c))
        except Exception as e:
            print(f"WARNING: checkpoint {c} unreadable ({e}); trying the "
                  "previous one")
    raise FileNotFoundError(f"no readable checkpoint in {ckpt_dir}")


def load_checkpoint(engine, path: str | None = None,
                    time_idx: int | None = None) -> int:
    """Restore a checkpoint into `engine`; returns the frame to resume at
    (the first frame not processed)."""
    from ..models import gaussians as G

    data, meta = read_checkpoint(engine.config, path, time_idx)
    dev = engine.device

    def dev_t(x):
        return torch.as_tensor(np.array(x, np.float32), device=dev)

    traj_q, traj_t = data["traj_quats"], data["traj_trans"]
    sections = []
    for i in range(meta["n_sections"]):
        p = {k: data[f"sec{i}_{k}"] for k, _ in G.PARAM_KEYS}
        p["cam_unnorm_rots"] = traj_q.T[None]
        p["cam_trans"] = traj_t.T[None]
        sec, _ = G.section_from_numpy_params(p, quantum=engine.quantum,
                                             device=dev)
        ts = data[f"sec{i}_timestep"]
        sec.vars.timestep[:len(ts)] = dev_t(ts)
        sec.vars.scene_radius = float(data[f"sec{i}_scene_radius"])
        sections.append(sec)
    engine.sections = sections
    engine.traj = G.CameraTrajectory(quats=dev_t(traj_q), trans=dev_t(traj_t))
    engine.gt_w2c = [g for g in data["gt_w2c"]]

    bs = engine.baseframes
    nb = data["baseframe_depths"].shape[0]
    rows = max(bs.quantum, -(-max(nb, 1) // bs.quantum) * bs.quantum)
    # the pool holds exact strided samples at the saving engine's stride
    stride = int(meta.get("baseframe_depth_stride", 1))
    depths = data["baseframe_depths"]
    bs.stride = stride
    bs.sH, bs.sW = depths.shape[1:] if nb else (bs.sH, bs.sW)
    bs.ids = [int(i) for i in meta["baseframe_ids"]]
    bs.depths = torch.zeros((rows, bs.sH, bs.sW), device=dev)
    bs.quats = torch.zeros((rows, 4), device=dev)
    bs.trans = torch.zeros((rows, 3), device=dev)
    bs.depths[:nb] = dev_t(depths)
    bs.quats[:nb] = dev_t(data["baseframe_quats"])
    bs.trans[:nb] = dev_t(data["baseframe_trans"])
    engine.ring_colors = dev_t(data["ring_colors"])
    engine.ring_depths = dev_t(data["ring_depths"])

    engine.tracking_corr = meta["tracking_corr"]
    engine.earliest_corr = meta["earliest_corr"]
    engine.mapping_corr = meta["mapping_corr"]
    engine.fixed_section_ids = (tuple(meta["fixed_section_ids"])
                                if meta["fixed_section_ids"] else None)
    engine.depth_means = list(meta["depth_means"])
    engine.num_gs_per_frame_ls = [int(n) for n in
                                  meta.get("num_gs_per_frame_ls", [])]
    saved = meta["stats"]
    for k in engine.stats:
        if k in saved:
            engine.stats[k] = saved[k]
    for jax_name, name in _JAX_STAT_ALIASES.items():
        if name not in saved and jax_name in saved:
            engine.stats[name] = saved[jax_name]
    engine.frame_color_loss = list(meta.get("frame_color_loss", []))
    engine.frame_depth_loss = list(meta.get("frame_depth_loss", []))
    engine._mpt_boost = int(meta.get("mpt_boost", 1))
    engine._harm_hist = [float(h) for h in meta.get("harm_hist", [])]
    engine._frames_tracked = int(meta.get("frames_tracked", 0))
    engine._pending_harm = None
    engine._pending_harm_mpt = None
    if "torch_map_generator" in data:
        engine.map_generator.set_state(
            torch.as_tensor(data["torch_map_generator"]))
        engine.select_generator.set_state(
            torch.as_tensor(data["torch_select_generator"]))
    else:
        print("NOTE: the checkpoint holds no torch generator states (written "
              "by the JAX package); the mapping and selection draws continue "
              "from the config's seed")
    engine.section_ids = {int(k): int(v)
                          for k, v in meta.get("section_ids", {}).items()}
    t = int(meta["time_idx"])
    engine._after_restore(t)
    return t + 1
