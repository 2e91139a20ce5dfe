"""Run logging, per-iteration loss records, per-frame progress reports, and
the engine's spans and counters.

Parity: `vtgaussian_slam_tpu/utils/observability.py` (the reference's wandb
plumbing). `RunLogger` logs to wandb when it imports and the run enables
it, else to `<run>/events.jsonl` with the same record names. Neither wandb
nor matplotlib is needed: both are imported inside the functions that use
them. `frame_quality` computes on the render's device and returns Python
floats from one device read.

`Trace` records the engine's spans, marks and counters per frame, in
memory (nothing is written out). Its stamps are `time.time_ns()`, the
clock `torch.profiler` keeps: a profiler event's absolute time is
`prof.profiler.kineto_results.trace_start_ns()` plus its
`time_range.start` (us) x 1000, so a span lands on the device trace's
timeline as it is. A span that ends on the engine's synchronise is
`synced` (its length is the device work it enqueued); any other span is
host time, its device cost read from a trace. The recorder itself never
synchronises and reads nothing from the device.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import NamedTuple

import numpy as np
import torch


class Span(NamedTuple):
    """One span (a mark: t0 == t1) of a frame, stamped in
    `time.time_ns()`; `parent` is the index of the enclosing span in the
    frame's list, -1 for the frame's root."""
    name: str
    t0: int
    t1: int
    parent: int
    synced: bool


class FrameRecord:
    """A frame's spans (in the order they opened, the root first) and
    counters, complete once the frame's block has closed."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counts: dict[str, int] = {}


class _Open:
    """A span while it is open; `t0`, `t1` (ns) readable once closed."""
    __slots__ = ("trace", "name", "t0", "t1", "index", "synced")

    def __init__(self, trace: "Trace", name: str):
        self.trace, self.name = trace, name
        self.t0 = self.t1 = 0
        self.index, self.synced = -1, False

    def __enter__(self):
        self.trace._enter(self)
        return self

    def __exit__(self, *exc):
        self.trace._exit(self)
        return False


class Trace:
    """The engine's spans, marks and counters.

    `frame()` opens a frame (its root span, named "frame") and yields the
    `FrameRecord` that collects what the frame records. Inside it,
    `span(name)` is a block, `mark(name)` a zero-length span, and
    `count(name, n)` adds n to the frame's counter. Every span and counter
    named in `totals` is also summed, in seconds or units, into
    `stats[totals[name]]`, in a frame or outside one (a checkpoint, the
    last page-outs of a run); outside a frame nothing else is kept.
    `synced()`, called by the engine's synchronise, marks the innermost
    open span synced until a child span opens or closes under it."""

    def __init__(self, stats: dict, totals: dict[str, str]):
        self.stats, self.totals = stats, totals
        self.record: FrameRecord | None = None
        self._open: list[_Open] = []

    def span(self, name: str) -> _Open:
        return _Open(self, name)

    def _enter(self, s: _Open):
        if self._open:
            self._open[-1].synced = False
        if self.record is not None:
            s.index = len(self.record.spans)
            self.record.spans.append(None)
        self._open.append(s)
        s.t0 = time.time_ns()

    def _exit(self, s: _Open):
        s.t1 = time.time_ns()
        self._open.pop()
        if self._open:
            self._open[-1].synced = False
        if self.record is not None and s.index >= 0:
            parent = self._open[-1].index if self._open else -1
            self.record.spans[s.index] = Span(s.name, s.t0, s.t1, parent,
                                              s.synced)
        key = self.totals.get(s.name)
        if key is not None:
            self.stats[key] += (s.t1 - s.t0) / 1e9

    def mark(self, name: str) -> int:
        """A zero-length span now; returns its stamp (ns)."""
        t = time.time_ns()
        if self.record is not None:
            parent = self._open[-1].index if self._open else -1
            self.record.spans.append(Span(name, t, t, parent, False))
        return t

    def count(self, name: str, n: int):
        if self.record is not None:
            self.record.counts[name] = self.record.counts.get(name, 0) + n
        key = self.totals.get(name)
        if key is not None:
            self.stats[key] += n

    def synced(self):
        if self._open:
            self._open[-1].synced = True

    @contextlib.contextmanager
    def frame(self):
        rec = self.record = FrameRecord()
        try:
            with self.span("frame"):
                yield rec
        finally:
            self.record = None
            self._open.clear()


def span_seconds(spans) -> dict[str, float]:
    """Seconds per span name, summed over a frame's spans."""
    out: dict[str, float] = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0.0) + (s.t1 - s.t0) / 1e9
    return out


def since_frame_start(times: dict, name: str) -> float | None:
    """Seconds from a frame's start (its root span) to the first span or
    mark called `name` in `frame_times[t]`; None where there is none."""
    spans = times.get("spans") or []
    hit = next((s for s in spans if s.name == name), None)
    if hit is None:
        return None
    return (hit.t0 - spans[0].t0) / 1e9


class RunLogger:
    """wandb if importable and enabled, else a JSONL event stream."""

    def __init__(self, enabled: bool, project: str = "", group: str = "",
                 name: str = "", entity: str = "", config: dict | None = None,
                 out_dir: str = "."):
        self.enabled = enabled
        self._wandb = None
        self._fh = None
        if not enabled:
            return
        try:
            import wandb
            self._wandb = wandb.init(project=project, entity=entity or None,
                                     group=group, name=name, config=config)
        except Exception:
            os.makedirs(out_dir, exist_ok=True)
            self._fh = open(os.path.join(out_dir, "events.jsonl"), "a")
            self._fh.write(json.dumps(
                {"event": "init", "project": project, "group": group,
                 "name": name, "t": time.time()}) + "\n")

    def log(self, data: dict):
        if not self.enabled:
            return
        if self._wandb is not None:
            self._wandb.log(data)
        elif self._fh is not None:
            self._fh.write(json.dumps(
                {**{k: _jsonable(v) for k, v in data.items()},
                 "t": time.time()}) + "\n")
            self._fh.flush()

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def _jsonable(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


def report_loss(losses: dict, logger: RunLogger, step: int,
                tracking: bool = False, mapping: bool = False) -> int:
    """One per-iteration loss record; returns the next step."""
    prefix = ("Per Iteration Tracking" if tracking
              else "Per Iteration Mapping" if mapping
              else "Per Iteration Current Frame Optimization")
    logger.log({
        f"{prefix}/Loss": losses.get("loss", 0.0),
        f"{prefix}/Image Loss": losses.get("im", 0.0),
        f"{prefix}/Depth Loss": losses.get("depth", 0.0),
        f"{prefix}/step": step,
    })
    return step + 1


def report_progress(logger: RunLogger, time_idx: int, est_w2c, gt_w2c_list,
                    psnr: float | None = None, depth_rmse: float | None = None):
    """Per-frame record: the latest frame's pose error (distance between
    the w2c translation columns, as the reference measures it) and the
    render quality."""
    rec = {"Tracking/step": time_idx}
    try:
        gt = np.asarray(gt_w2c_list[time_idx], np.float64)
        est = np.asarray(est_w2c, np.float64)
        rec["Tracking/Latest Pose Error"] = float(
            np.linalg.norm(est[:3, 3] - gt[:3, 3]))
    except Exception:
        pass
    if psnr is not None:
        rec["Tracking/PSNR"] = psnr
    if depth_rmse is not None:
        rec["Tracking/Depth RMSE"] = depth_rmse
    logger.log(rec)


@torch.no_grad()
def frame_quality(render, frame, sil_thres: float):
    """(PSNR, depth "RMSE", depth L1, mask) of a render at the tracked pose
    (`render` a core.losses.RenderResult, `frame` a core.losses.Frame): the
    presence-masked images' PSNR with the MSE over all pixels, and the
    presence-masked depth error over the valid-depth count. The "RMSE" is
    the reference's elementwise sqrt of the squared error, i.e. the L1."""
    im = torch.clamp(render.im, 0, 1).double()
    gt_im = frame.color.double()
    depth = render.depth[0].double()
    gt_depth = frame.depth[0].double()
    presence = render.silhouette > sil_thres
    valid = frame.depth[0] > 0
    mask = presence & valid
    p = presence.double()
    mse = ((im * p[None] - gt_im * p[None]) ** 2).mean()
    derr = (depth - gt_depth) * p * valid.double()
    mse, dsum, nv = torch.stack(
        [mse, derr.abs().sum(), valid.sum().double()]).tolist()
    psnr = float(-10.0 * np.log10(max(mse, 1e-12)))
    depth_l1 = dsum / max(int(nv), 1)
    return psnr, depth_l1, depth_l1, mask


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def save_tracking_loss_viz(path: str, render, frame, sil_thres: float,
                           aux_mask=None, im_hist=None, depth_hist=None,
                           title: str = ""):
    """Tracking-loss figure of one frame at its final tracked pose, with
    the per-iteration loss curves (the reference draws one still per
    iteration; the curves carry that signal). Needs matplotlib."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    im = np.clip(_host(render.im), 0, 1)
    gt_im = _host(frame.color)
    depth = _host(render.depth)[0]
    gt_depth = _host(frame.depth)[0]
    presence = _host(render.silhouette) > sil_thres
    mask = presence & (gt_depth > 0)
    if aux_mask is not None:
        mask = mask & _host(aux_mask)
    w_im = im * mask[None]
    w_gt_im = gt_im * mask[None]
    w_depth = depth * mask
    w_gt_depth = gt_depth * mask
    diff_rgb = np.abs(w_im - w_gt_im).mean(0)
    diff_depth = np.abs(w_depth - w_gt_depth)
    vmax = float(max(gt_depth.max(), 1e-6))

    fig, ax = plt.subplots(2, 5, figsize=(18, 6))
    panels = [
        (0, 0, gt_im.transpose(1, 2, 0), {}, "GT RGB"),
        (1, 0, w_im.transpose(1, 2, 0), {}, "Weighted Rendered RGB"),
        (0, 1, gt_depth, dict(cmap="jet", vmin=0, vmax=vmax), "GT Depth"),
        (1, 1, w_depth, dict(cmap="jet", vmin=0, vmax=vmax),
         "Weighted Rendered Depth"),
        (0, 2, diff_rgb, dict(cmap="jet", vmin=0, vmax=0.8), "Diff RGB"),
        (1, 2, diff_depth, dict(cmap="jet", vmin=0, vmax=0.8), "Diff Depth"),
        (0, 3, presence, dict(cmap="gray"), "Silhouette Mask"),
        (1, 3, mask, dict(cmap="gray"), "Loss Mask"),
    ]
    for r_, c_, img, kw, name in panels:
        ax[r_, c_].imshow(img, **kw)
        ax[r_, c_].set_title(name, fontsize=9)
        ax[r_, c_].axis("off")
    for row, hist, name in ((0, im_hist, "im loss / iter"),
                            (1, depth_hist, "depth loss / iter")):
        if hist is not None:
            ax[row, 4].plot(_host(hist))
            ax[row, 4].set_title(name, fontsize=9)
        else:
            ax[row, 4].axis("off")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, bbox_inches="tight", dpi=90)
    plt.close(fig)


def save_progress_panel(path: str, render, frame, sil_thres: float,
                        title: str = ""):
    """The 2x4 qualitative panel (GT / rendered RGB and depth, silhouette,
    presence mask, L1 diff images) as one PNG. Needs matplotlib."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    im = np.clip(_host(render.im), 0, 1).transpose(1, 2, 0)
    gt_im = _host(frame.color).transpose(1, 2, 0)
    depth = _host(render.depth)[0]
    gt_depth = _host(frame.depth)[0]
    sil = _host(render.silhouette)
    presence = sil > sil_thres
    vmax = float(max(gt_depth.max(), 1e-6))
    rgb_diff = np.abs(im - gt_im).mean(-1)
    depth_diff = np.abs(depth - gt_depth) * (gt_depth > 0)

    fig, ax = plt.subplots(2, 4, figsize=(14, 6))
    panels = [
        (gt_im, None, "GT RGB"),
        (gt_depth, dict(cmap="jet", vmin=0, vmax=vmax), "GT Depth"),
        (sil, dict(cmap="gray", vmin=0, vmax=1), "Silhouette"),
        (rgb_diff, dict(cmap="jet", vmin=0, vmax=0.2), "RGB L1 Diff"),
        (im, None, "Rendered RGB"),
        (depth, dict(cmap="jet", vmin=0, vmax=vmax), "Rendered Depth"),
        (presence, dict(cmap="gray", vmin=0, vmax=1), "Presence Mask"),
        (depth_diff, dict(cmap="jet", vmin=0, vmax=0.3), "Depth L1 Diff"),
    ]
    for a, (img, kw, name) in zip(ax.ravel(), panels):
        a.imshow(img, **(kw or {}))
        a.set_title(name, fontsize=9)
        a.axis("off")
    if title:
        fig.suptitle(title)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, bbox_inches="tight", dpi=90)
    plt.close(fig)
