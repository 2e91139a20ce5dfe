"""One run of one cell: build, make the sequence, set up the engine, warm
up on frames 0 and 1, drive `VTGaussianSLAM.process_frame` in a closed
loop for the window, then check the sampled frames against the reference
and print the result line.

`run_cell` takes the device, so the CPU tests can drive a whole run at a
tiny size; `portbench/run.py` is the entry point on the card.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import math
import os
import statistics
import sys
import time

import numpy as np
import torch

from . import check as chk
from .capture import Capture
from .spec import ROOT, Cell, metric_reader

FORBIDDEN = ("jax", "jaxlib", "flax", "vtgaussian_slam_tpu")
PROFILED = (2, 3)         # window frames traced under torch.profiler
KERNEL_FRAME = 4          # the frame whose K2 / K3 launches are sampled
KERNEL_REPEATS = 10
MEM_FRAMES = 32           # window frames whose peak memory is reported


class RunFailed(Exception):
    """The run cannot give a result (it says why)."""


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def sequence_dir(root: str, cell: str, seed: int) -> str:
    return os.path.join(root, ".portbench_cache", "sequences", cell, str(seed))


def engine_config(cell: Cell, seq_dir: str) -> dict:
    """The configuration as it is run: the file's, pointed at the
    sequence. The engine keeps the configuration's own seed: it draws the
    keyframes mapping trains on, and through them the truncation probe
    that sizes the pair budget, so a seed of the run's own put runs of
    one cell on different budgets and memory."""
    cfg = copy.deepcopy(cell.config["config"])
    d = cfg["data"]
    d["basedir"] = os.path.dirname(seq_dir)
    d["sequence"] = os.path.basename(seq_dir)
    d["gradslam_data_cfg"] = os.path.join(seq_dir, "camera.yaml")
    return cfg


def check_frames(cfg: dict, seed: int, first: int) -> list[int]:
    """The frames the check samples, so that every run of a configuration
    checks the same stages whatever its seed and scene family: one drawn
    from the seed among the first three frames from `first` on that are
    not section boundaries (its tracking, densification and mapping), and
    the first section boundary from `first` on (its spawn, and its mapping
    over the global binning that the boundary's new frozen sections make
    it build)."""
    bfe = int(cfg["baseframe_every"])
    rng = np.random.default_rng([int(seed), 11])
    inner = [t for t in range(first, first + 6) if t % bfe][:3]
    return [inner[int(rng.integers(0, 3))], bfe * -(-first // bfe)]


def _phases(times: dict) -> list[tuple[str, float]]:
    """A frame's phases in the order `process_frame` runs them."""
    tm = times.get("timers", {})
    return [("load", tm.get("t_dataset", 0.0) + tm.get("t_stage", 0.0)),
            ("track", times["track"]), ("spawn", times["spawn"]),
            ("densify", times["densify"]), ("map", times["map"])]


class Window:
    """What the metric readers see: the frames driven after the warm-up,
    each with its wall time, the program's `frame_times[t]` and whether it
    ran inside the window (frames after it run on untimed for the check),
    and with --trace 1 the profile and the sampled kernels. The frame whose
    tracking loop the check splits (`split`) counts in no timed
    statistic."""

    def __init__(self, cell: str, bfe: int, split: int):
        self.cell, self.bfe, self.split = cell, bfe, split
        self.frames: list[dict] = []
        self.profiled: set[int] = set()
        self.device: dict | None = None      # busy_s, window_s, idle share
        self.kernels: dict[str, dict] = {}

    def unhooked(self) -> list[dict]:
        """The frames, in the window or after it, that ran without the
        profiler and without the check's split."""
        return [f for f in self.frames
                if f["t"] not in self.profiled and f["t"] != self.split]

    def timed(self) -> list[dict]:
        """The window's frames that ran without the profiler and without
        the check's split."""
        return [f for f in self.unhooked() if f["window"]]


# ----------------------------------------------------------------------
def _profile_summary(prof, spans) -> dict:
    """Device busy time inside the profiled frames (the union of the
    device operations' intervals), the idle gaps by the phase the host was
    in, and the device operations with the most time."""
    dev = torch.autograd.DeviceType.CUDA
    ivs, by_name = [], {}
    for e in prof.events():
        # the frame spans this harness opens show on the device's timeline
        # too; they are no device work
        if e.device_type != dev or e.name.startswith("portbench."):
            continue
        a, b = e.time_range.start, e.time_range.end
        if b > a:
            ivs.append((a, b))
            by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e6
    ivs.sort()
    busy, window, gaps = 0.0, 0.0, []
    for s0, s1, phases in spans:
        window += s1 - s0
        cur = s0
        for a, b in ivs:
            a, b = max(a, s0), min(b, s1)
            if b <= a:
                continue
            if a > cur:
                gaps.append((a - cur, cur, phases))
            busy += b - max(a, cur) if b > cur else 0.0
            cur = max(cur, b)
        if s1 > cur:
            gaps.append((s1 - cur, cur, phases))
    named = []
    for g, at, phases in sorted(gaps, key=lambda x: -x[0])[:10]:
        label = phases[-1][0]
        for name, start in phases:
            if at >= start:
                label = name
        named.append([f"host in {label}", g / 1e6])
    return dict(busy_s=busy / 1e6, window_s=window / 1e6,
                device_ops=sorted(([k, v] for k, v in by_name.items()),
                                  key=lambda x: -x[1])[:10],
                idle_gaps=named)


def _time_kernel(fn) -> float:
    """Median of KERNEL_REPEATS one-call CUDA-event timings, seconds."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(KERNEL_REPEATS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / 1e3)
    return statistics.median(ts)


def _kernel_rooflines(samples: dict) -> dict:
    """Each sampled launch (K2, K3) timed again and its least time."""
    from ..reference.ops.rasterizer import cuda_splat as rsplat
    from . import roofline as rl
    out = {}
    for name, (fn, args) in samples.items():
        slots8, R9, trans, counts, accum, g, cam, tiles_x = args[:8]
        t = _time_kernel(lambda: fn(*args))
        cp = rsplat.cp_vector(R9, trans, cam)
        work = rl.walk_work(slots8, counts, cp, tiles_x)
        T, _, M = slots8.shape
        b, by = rl.bound_s(name, work, rl.kernel_bytes(name, T, M,
                                                       work["slots"]))
        out[name] = dict(time_s=t, bound_s=b, bound_by=by, **work)
    return out


# ----------------------------------------------------------------------
def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_process0: float | None = None,
             root: str = ROOT, cache_root: str | None = None,
             readings: bool = False,
             min_frames: int = 1, check_from: int = MEM_FRAMES + 2,
             log=sys.stderr) -> dict:
    """One run; returns the result object. Raises RunFailed where the
    run can give no result. `cache_root` holds the sequences (default the
    checkout); `readings` adds the control's numbers, judged as the
    program's; the window runs at least `min_frames` frames (a test's tiny
    run). The check samples frames
    from `check_from` on: by default after the frames whose peak memory
    `peak_mem_gib` reports, so that what the check holds does not count
    there. A window that ends first runs on, untimed, through them."""
    t_process0 = time.time() if t_process0 is None else t_process0
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    from . import imageio_shim
    from .sequence import write_sequence
    imageio_shim.install()
    if cuda:
        from vtgaussian_slam_tpu_torch.ops.rasterizer import _build
        built = _build.build_all()
        print(f"[setup] kernels ready in {built:.2f} s", file=log)

    fmt = cell.config["format"]
    cam = cell.config["camera"]
    seq_dir = sequence_dir(cache_root or root, cell.name, seed)
    if not os.path.isdir(seq_dir):
        t0 = time.time()
        info = write_sequence(seq_dir, fmt, cam, cell.traffic, seed, dev)
        print(f"[setup] sequence {seq_dir}: {info['frames']} frames, "
              f"{info['bytes'] / 2**20:.1f} MiB written in "
              f"{time.time() - t0:.2f} s", file=log)
    else:
        print(f"[setup] sequence {seq_dir} found", file=log)

    cfg = engine_config(cell, seq_dir)
    from vtgaussian_slam_tpu_torch.core.pipeline import VTGaussianSLAM
    engine = VTGaussianSLAM(cfg, device=device)
    sampled = check_frames(cfg, seed, check_from)
    cap = Capture(engine, sampled, split=sampled[0])
    cap.take_start()
    cap.install()
    for t in (0, 1):
        engine.process_frame(t)
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - t_process0

    win = Window(cell.name, int(cfg["baseframe_every"]), split=sampled[0])
    prof = None
    samples: dict = {}
    if trace:
        win.profiled = set(PROFILED)
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        prof = profile(activities=acts)

    n_frames = engine.num_frames
    t = 2
    t_w0 = time.time()
    t_end = t_w0
    mem_peak_frames = None
    while True:
        if t >= n_frames:
            raise RunFailed(
                f"the sequence ran out of frames at frame {t} after "
                f"{time.time() - t_w0:.1f} s of the {seconds} s window: the "
                f"traffic's 'frames' is too small for this rate")
        profiling = trace and t in win.profiled
        sampling = trace and t == KERNEL_FRAME and cuda
        if profiling and t == PROFILED[0]:
            prof.__enter__()
        span = (torch.profiler.record_function(f"portbench.frame.{t}")
                if profiling else contextlib.nullcontext())
        with cap.frame(t), _sample_kernels(samples, sampling), span:
            f0 = time.time()
            engine.process_frame(t)
            if cuda:
                torch.cuda.synchronize()
            f1 = time.time()
        if profiling and t == PROFILED[-1]:
            prof.__exit__(None, None, None)
        win.frames.append(dict(t=t, wall_s=f1 - f0, times=engine.frame_times[t],
                               boundary=t % win.bfe == 0, window=True))
        t_end = f1
        t += 1
        if cuda and len(win.frames) == MEM_FRAMES:
            mem_peak_frames = torch.cuda.max_memory_allocated()
        if f1 - t_w0 >= seconds and len(win.frames) >= min_frames:
            break
    window_s = t_end - t_w0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    mem_peak = max(peak, setup_peak) if cuda else 0
    while t < n_frames and (t <= max(cap.frames) or (
            cuda and not trace and mem_peak_frames is None)):
        # a window that ends before the MEM_FRAMES frames or the checked
        # ones runs on, untimed: peak_mem_gib always covers the same
        # frames, and the check always has its own
        with cap.frame(t):
            engine.process_frame(t)
        if cuda:
            torch.cuda.synchronize()
        win.frames.append(dict(t=t, wall_s=None, times=engine.frame_times[t],
                               boundary=t % win.bfe == 0, window=False))
        t += 1
        if cuda and len(win.frames) == MEM_FRAMES:
            mem_peak_frames = torch.cuda.max_memory_allocated()

    # the frame whose tracking the check split is left out of the rate and
    # the tail, its time with it
    in_window = [f for f in win.frames if f["window"]]
    walls = [f["wall_s"] for f in in_window if f["t"] != win.split]
    split_s = sum(f["wall_s"] for f in in_window if f["t"] == win.split)
    window_s -= split_s
    metrics: dict = {}
    if not trace:
        values = {"frames_per_s": len(walls) / window_s,
                  "frame_s_p95": float(np.percentile(walls, 95)),
                  "peak_mem_gib": (mem_peak_frames or 0) / 2**30,
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
        left_out = (f" (frame {win.split}, split by the check, left out)"
                    if split_s else "")
        print(f"[window] {len(walls)} frames in {window_s:.3f} s{left_out}; "
              f"frame wall s: p50 {np.percentile(walls, 50):.4f}, p95 over "
              f"{len(walls)} samples {np.percentile(walls, 95):.4f}, max "
              f"{max(walls):.4f}", file=log)
    for f in in_window:
        tm = f["times"]
        print(f"[frame {f['t']}] wall {f['wall_s']:.4f} s: track "
              f"{tm['track']:.4f} spawn {tm['spawn']:.4f} densify "
              f"{tm['densify']:.4f} map {tm['map']:.4f}"
              + (" (boundary)" if f["boundary"] else "")
              + (" (profiled)" if f["t"] in win.profiled else "")
              + (" (split by the check)" if f["t"] == win.split else ""),
              file=log)

    print(f"[window] ATE {engine.ate(t) * 100:.4f} cm over frames 0-{t - 1} "
          f"(Horn-aligned, against the sequence's poses); the check's "
          f"captures hold {cap.held_bytes() / 2**20:.1f} MiB on the card",
          file=log)
    # the program's state goes before the reference runs
    cap.engine = None
    del engine
    gc.collect()
    if trace:
        if cuda:
            win.device = _device_summary(prof, win)
            win.kernels = _kernel_rooflines(samples)
        samples.clear()
        for m in cell.per_layer:
            v = metric_reader(m["name"], root)(win)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if cuda:
        torch.cuda.empty_cache()

    s = chk.Setting(cfg, chk.Sequence(seq_dir, fmt, cam), dev)
    nums = chk.numbers(s, cap.records, cap.start)
    control = (chk.numbers(s, cap.records, cap.start, control=True)
               if readings else None)
    correct, check = judge(nums, cell)
    bad = forbidden_modules()
    if bad:
        raise RunFailed("loaded in the process that prints the result: "
                        + ", ".join(bad))
    result = {"correct": bool(correct), "attempted": len(in_window),
              "failed": 0,
              "metrics": metrics, "device": _device_info(cuda, mem_peak, win)}
    if trace and win.device:
        result["breakdown"] = {"device_ops": win.device["device_ops"],
                               "idle_gaps": win.device["idle_gaps"]}
    if control is not None:
        c_correct, c_check = judge(control, cell)
        result["control"] = {"correct": c_correct, "check": c_check}
    result["check"] = check
    for name, c in check.items():
        print(f"check: {name} {c['value']} limit {c['limit']}", file=log)
    return result


def judge(nums: dict, cell: Cell) -> tuple[bool, dict]:
    """Each number beside its limit, and whether every one holds; a number
    with no limit fails the run."""
    check = {}
    correct = True
    for name, limit in sorted(cell.limits.items()):
        v = nums.get(name)
        ok = v is not None and math.isfinite(v) and v <= limit
        correct &= ok
        check[name] = {"value": v, "limit": limit}
    extra = sorted(set(nums) - set(cell.limits))
    if extra:
        raise RunFailed(f"numbers with no limit in portbench/limits/"
                        f"{cell.name}.json: {extra}")
    return correct, check


def _device_summary(prof, win: Window) -> dict:
    """`_profile_summary` over the profiled frames, each frame's phases
    laid out from its start by `frame_times`."""
    cpu = torch.autograd.DeviceType.CPU
    evs = [e for e in prof.events()
           if e.device_type == cpu and e.name.startswith("portbench.frame.")]
    out_spans = []
    for e in evs:
        t = int(e.name.rsplit(".", 1)[1])
        times = next(f["times"] for f in win.frames if f["t"] == t)
        s0, s1 = e.time_range.start, e.time_range.end
        cur, phases = s0, []
        for name, dt in _phases(times):
            phases.append((name, cur))
            cur += dt * 1e6
        out_spans.append((s0, s1, phases))
    return _profile_summary(prof, out_spans)


def _device_info(cuda: bool, mem_peak: int, win: Window) -> dict:
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
         "count": 1, "memory_peak_bytes": int(mem_peak)}
    if win.device:
        d["busy_s"] = win.device["busy_s"]
        d["window_s"] = win.device["window_s"]
    return d


class _Recorder:
    """A kernel wrapper that records its first call's arguments into
    `samples[name]`; the wrapper's launch counter stays the real one."""

    def __init__(self, real, name: str, samples: dict):
        self.real, self.name, self.samples = real, name, samples

    @property
    def launches(self):
        return self.real.launches

    @launches.setter
    def launches(self, n):
        self.real.launches = n

    def __call__(self, *a, **k):
        if self.name not in self.samples:
            self.samples[self.name] = (self.real, a)
        return self.real(*a, **k)


class _sample_kernels:
    """While on, record the first K2 and the first K3 launch of the frame
    (their wrappers and arguments) into `samples`."""

    def __init__(self, samples: dict, on: bool):
        self.samples, self.on = samples, on

    def __enter__(self):
        if not self.on:
            return self
        from vtgaussian_slam_tpu_torch.core import map_cache
        from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_splat
        self.mods = [(cuda_splat, "splat_backward_pose", "K2"),
                     (map_cache, "splat_backward_vals_rows", "K3")]
        self.old = [getattr(mod, attr) for mod, attr, _ in self.mods]
        for (mod, attr, name), real in zip(self.mods, self.old):
            setattr(mod, attr, _Recorder(real, name, self.samples))
        return self

    def __exit__(self, *exc):
        if self.on:
            for (mod, attr, _), real in zip(self.mods, self.old):
                setattr(mod, attr, real)
        return False
