"""Config schema handling.

The port's own copy of `vtgaussian_slam_tpu/core/config.py`: scene configs
are Python modules exporting a nested `config` dict (configs/), and this
backfills the same runtime defaults as the JAX engine so both read the
same files, and refuses the JAX engine's tuning keys the port does not
implement (`RETIRED_TPU`). `auto_pair_budget` sizes the rasterizer's
per-tile pair budget from a map's density, for the engine and for the
evaluation renders.
"""
from __future__ import annotations

import copy

# frames between two truncation probes once two readings exist
TRUNC_PROBE_EVERY = 10
# the most per-keyframe binnings a mapping phase keeps
MAP_CACHE_SLOTS = 64
# `tpu` keys of the JAX engine that the port does not read, each with the
# one value it implements (None: the config's own max_pairs_per_tile): a
# config may spell that value; any other raises
RETIRED_TPU = {"two_class_frac": 0, "two_class_sparse_div": 4,
               "track_rebin_every": 0, "map_cache_refresh": 1,
               "trunc_probe_every": TRUNC_PROBE_EVERY,
               "map_cache_slots": MAP_CACHE_SLOTS,
               "map_max_pairs_per_tile": None}


def auto_pair_budget(n_active: int, n_tiles: int, span_cap: int, base: int,
                     tile_cap_entries: int = 1 << 23, hard_cap: int = 8192,
                     boost: int = 1) -> int:
    """Power-of-two `max_pairs_per_tile` for the current section density:
    about 1/12 of the average per-tile pair count (1/4 on images of fewer
    than 64 tiles) times `boost`, doubled up from `base`, capped so the
    record buffers stay bounded."""
    divisor = 12 if n_tiles >= 64 else 4
    need = boost * (n_active * span_cap * span_cap) // (
        divisor * max(n_tiles, 1))
    cap = max(base, min(hard_cap, tile_cap_entries // max(n_tiles, 1)))
    mpt = base
    while mpt < need and mpt * 2 <= cap:
        mpt *= 2
    return mpt


def prepare_config(config: dict) -> dict:
    config = copy.deepcopy(config)
    tr = config.setdefault("tracking", {})
    tr.setdefault("use_depth_loss_thres", False)
    tr.setdefault("depth_loss_thres", 100000)
    tr.setdefault("visualize_tracking_loss", False)
    tr.setdefault("base1_num_iters", None)
    tr.setdefault("sil_thres_base", None)
    tr.setdefault("forward_prop", True)
    tr.setdefault("frustum", True)
    tr.setdefault("p2p_method", "sum")
    # onlybase_overlap=False (per-iteration p2p against every candidate
    # base) is an ablation no shipped config enables; descoped (PARITY.md).
    tr.setdefault("onlybase_overlap", True)
    if not tr["onlybase_overlap"]:
        raise NotImplementedError(
            "onlybase_overlap=False is a descoped reference ablation "
            "(off in every shipped config); see PARITY.md")
    tr.setdefault("edge", 20)
    tr.setdefault("keyframe_thresh", 0.5)
    tr.setdefault("kf_depth_thresh", 0.01)
    tr.setdefault("earliest_thres", 0.5)
    tr.setdefault("lower_earliest_thres_percent", 0.8)
    tr.setdefault("topk_base", 3)
    tr.setdefault("vis_mask_thres", 0.05)
    tr.setdefault("use_gt_poses", False)

    config.setdefault("gaussian_distribution", "isotropic")
    config.setdefault("use_wandb", False)
    config.setdefault("eval_mode", False)
    config.setdefault("eval_every", 1000)
    config.setdefault("load_checkpoint", False)
    config.setdefault("map_every", 1)
    config.setdefault("keyframe_every", 1)
    config.setdefault("mapping_window_size", 3)
    config.setdefault("report_global_progress_every", 1)
    config.setdefault("report_iter_progress", False)
    config.setdefault("overlap_every", config.get("baseframe_every", 40))
    config.setdefault("far_depth_factor", 2.0)
    config.setdefault("seed", 0)

    data = config.setdefault("data", {})
    data.setdefault("ignore_bad", False)
    data.setdefault("use_train_split", True)
    if "densification_image_height" not in data:
        data["densification_image_height"] = data.get("desired_image_height")
        data["densification_image_width"] = data.get("desired_image_width")

    mp = config.setdefault("mapping", {})
    mp.setdefault("fixed_lrs", {k: 0.0 for k in (
        "means3D", "rgb_colors", "unnorm_rotations", "logit_opacities",
        "log_scales", "cam_unnorm_rots", "cam_trans")})

    # engine knobs (absent from reference configs; safe defaults)
    tpu = config.setdefault("tpu", {})
    tpu.setdefault("capacity_quantum", 1 << 15)
    # span 3 covers splats up to ~24 px screen radius; span 2 is ~40%
    # cheaper to bin/sort and safe when splats stay under ~1 tile (high-res
    # scenes) — opt in per config via tpu.span_cap
    tpu.setdefault("span_cap", 3)
    # per-tile pair budget: must exceed the scene's per-tile depth
    # complexity or silhouettes develop false holes and densification
    # over-adds (watch final_stats tile_truncation_frac_max). With
    # auto_pair_budget (default) this is the FLOOR; the engine re-buckets
    # upward in powers of two as sections grow (core/pipeline.py:
    # auto_pair_budget).
    tpu.setdefault("max_pairs_per_tile", 512)
    tpu.setdefault("auto_pair_budget", True)
    tpu.setdefault("blend_chunk", 128)
    # rebuild cadence (frames) of the frozen global-consistency binning —
    # the MapCacheStore staleness policy applied to the global term; 1 =
    # rebuild every mapping phase (exact), larger trades ~0.2 s/frame of
    # binning for gaussians densified since the build missing the global
    # term (not the local terms) for <= K-1 frames
    tpu.setdefault("global_cache_refresh_every", 4)
    tpu.setdefault("baseframe_capacity_quantum", 64)
    # selection candidate-pool depths are stored subsampled by this stride
    # so the pool's device memory grows /stride^2 with sequence length
    # (pipeline.BaseframeStore; 1 = full-res exact)
    tpu.setdefault("baseframe_depth_stride", 4)
    for key, value in RETIRED_TPU.items():
        value = tpu["max_pairs_per_tile"] if value is None else value
        if key in tpu and tpu[key] != value:
            raise ValueError(
                f"tpu.{key}={tpu[key]!r}: the port implements only "
                f"{value!r}; drop the key or set it to that value")
    return config


def separate_densification_res(config: dict) -> bool:
    d = config["data"]
    return (d["densification_image_height"] != d["desired_image_height"]
            or d["densification_image_width"] != d["desired_image_width"])
