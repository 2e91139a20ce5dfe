"""The engine's spans and counters (utils/observability.Trace): a tiny
synthetic engine across two section boundaries on each of two routes (the
Replica selection with the binned mapping loop and a depth-loss rerun every
frame; the TUM selection, whose boundaries track each candidate section,
with the generic mapping loop).

Every frame's spans nest in one root; `frame_times[t]`'s phases and timers
are sums of its spans and the run's `stats` the sums of those; the counters
count what ran; the recorder adds no synchronise and no read of a tensor to
a frame (the counts are the engine's before it had spans); and a frame's
spans lie on the profiler's clock.
"""
import pytest
import torch

from torch_port_util import smoke_config
from vtgaussian_slam_tpu_torch.core.pipeline import (PHASES, STAT_TOTALS,
                                                      TIMER_SPANS,
                                                      VTGaussianSLAM)
from vtgaussian_slam_tpu_torch.utils.observability import (Trace,
                                                           span_seconds)

ITERS = 3
BFE = 2             # boundaries at frames 2 and 4
COUNTED = 6         # frames 0-5 run with the counting wrappers
FRAMES = COUNTED + 1  # frame 6 runs under the profiler
ROUTES = {
    "replica_binned": dict(selection_style="replica",
                           tpu={"map_binned": True},
                           tracking={"use_depth_loss_thres": True,
                                     "depth_loss_thres": 0.0}),
    "tum_generic": dict(selection_style="tum", tpu={"map_binned": False}),
}
READS = ("item", "cpu", "tolist", "__float__")
# per frame 0-5: the engine's _sync() calls and its reads of tensors
# (Tensor.item / cpu / tolist / __float__), counted the same way on the
# engine as it was before the recorder replaced its timers, less the two
# host floats an iteration took for the bias corrections before the
# tracking loop held them in a device table
PARENT_COUNTS = {
    "replica_binned": [(2, 0, 0, 0, 42), (7, 0, 1, 0, 142),
                       (7, 0, 1, 0, 156), (7, 0, 1, 0, 117),
                       (7, 0, 2, 0, 131), (7, 0, 1, 0, 117)],
    "tum_generic": [(2, 0, 0, 0, 6), (6, 0, 1, 0, 57), (6, 0, 1, 0, 59),
                    (6, 0, 1, 0, 44), (6, 0, 2, 0, 46), (6, 0, 1, 0, 44)],
}


def run_route(route: str, workdir, frames: int = COUNTED):
    """The engine of a route after frames 0 .. frames-1, each run with
    _sync() and the tensor reads counted; returns (engine, per-frame
    (sync, item, cpu, tolist, __float__))."""
    cfg = smoke_config(workdir, frames=FRAMES, iters=ITERS,
                       baseframe_every=BFE, **ROUTES[route])
    eng = VTGaussianSLAM(cfg, device="cpu")
    n = dict.fromkeys(("sync",) + READS, 0)
    real_sync = VTGaussianSLAM._sync
    reals = {k: getattr(torch.Tensor, k) for k in READS}

    def sync(self):
        n["sync"] += 1
        return real_sync(self)

    def counted(k):
        def read(self, *a, **kw):
            n[k] += 1
            return reals[k](self, *a, **kw)
        return read

    per = []
    VTGaussianSLAM._sync = sync
    for k in READS:
        setattr(torch.Tensor, k, counted(k))
    try:
        for t in range(frames):
            n.update(dict.fromkeys(n, 0))
            eng.process_frame(t)
            per.append(tuple(n[k] for k in ("sync",) + READS))
    finally:
        VTGaussianSLAM._sync = real_sync
        for k in READS:
            setattr(torch.Tensor, k, reals[k])
    return eng, per


@pytest.fixture(scope="module", params=sorted(ROUTES))
def run(request, tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        eng, per = run_route(request.param,
                             tmp_path_factory.mktemp(request.param))
        yield request.param, eng, per
        eng.close()
    finally:
        torch.set_num_threads(threads)


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_every_span_nests_in_its_parent_under_one_root(run):
    _, eng, _ = run
    for t in range(COUNTED):
        spans = eng.frame_times[t]["spans"]
        assert spans[0].name == "frame" and spans[0].parent == -1
        assert [s.parent for s in spans].count(-1) == 1, t
        for i, s in enumerate(spans[1:], 1):
            p = spans[s.parent]
            assert 0 <= s.parent < i, (t, s)
            assert p.t0 <= s.t0 <= s.t1 <= p.t1, (t, s, p)


def test_phases_and_timers_are_span_sums(run):
    _, eng, _ = run
    timers_total: dict = {}
    for t in range(COUNTED):
        ft = eng.frame_times[t]
        sums = span_seconds(ft["spans"])
        for p in PHASES:
            assert ft[p] == sums.get(p, 0.0), (t, p)
        assert ft["timers"] == {k: sums[n] for n, k in TIMER_SPANS.items()
                                if n in sums}
        assert {"t_dataset", "t_stage"} <= set(ft["timers"]) or t == 0
        for k, v in ft["timers"].items():
            timers_total[k] = timers_total.get(k, 0.0) + v
    # the run's stats are the sums of the frames' (nothing ran outside
    # a frame yet); t_densify and the map phase alike
    for k, v in timers_total.items():
        assert eng.stats[k] == pytest.approx(v, rel=1e-9, abs=1e-12), k
    assert eng.stats["t_densify"] == pytest.approx(
        sum(eng.frame_times[t]["densify"] for t in range(COUNTED)))
    assert eng.stats["mapping_frame_time_sum"] == pytest.approx(
        sum(eng.frame_times[t]["map"] for t in range(COUNTED)))
    loops = sum(span_seconds(eng.frame_times[t]["spans"]).get("track.loop", 0)
                for t in range(COUNTED))
    assert eng.stats["tracking_loop_time_sum"] == pytest.approx(loops)


def test_iteration_counters_count_the_iterations_run(run):
    route, eng, _ = run
    cands = {row[0]: row[2] for row in eng.earliest_corr
             if row[1] == "selected_baseframes"}
    for t in range(COUNTED):
        c = eng.frame_times[t]["counts"]
        assert c["map.iters"] == ITERS, (t, c)
        if t == 0:
            assert "track.iters" not in c
        elif route == "replica_binned":
            # every frame reruns its loop (depth_loss_thres 0)
            assert c["track.iters"] == 2 * ITERS, (t, c)
        elif t % BFE == 0:
            # a TUM boundary runs each candidate section's loop
            assert len(cands[t]) >= 1
            assert c["track.iters"] == ITERS * len(cands[t]), (t, c)
        else:
            assert c["track.iters"] == ITERS, (t, c)
        if t > 0:
            # the CPU runs every cached iteration eagerly
            assert c["track.graph_iters"] == 0, (t, c)
    total = lambda k: sum(eng.frame_times[t]["counts"].get(k, 0)
                          for t in range(COUNTED))
    assert eng.stats["tracking_loop_iters"] == total("track.iters")
    assert eng.stats["mapping_loop_iters"] == total("map.iters")
    assert eng.stats["section_page_outs"] == total("page.outs")


def test_binnings_built_counts_the_keyframe_store_builds(run):
    route, eng, _ = run
    for t in range(COUNTED):
        c = eng.frame_times[t]["counts"]
        if route == "replica_binned":
            # the new keyframe's binning at least, at most one per
            # keyframe of the section so far
            assert 1 <= c["map.binnings_built"] <= t % BFE + 1, (t, c)
        else:
            assert "map.binnings_built" not in c, (t, c)  # generic route
    assert set(eng.frame_times[1]["counts"]) <= {
        "track.iters", "track.graph_iters", "map.iters", "map.binnings_built",
        "map.loss_fused", "map.slot_kernels", "page.outs", "page.ins"}


def test_no_mapping_loss_is_fused_on_the_cpu(run):
    """`map.loss_fused` counts the mapping iterations whose loss took the
    card's kernel: on the CPU, on either route, every frame records 0."""
    _, eng, _ = run
    for t in range(COUNTED):
        assert eng.frame_times[t]["counts"]["map.loss_fused"] == 0, t


def test_no_slot_kernel_runs_on_the_cpu(run):
    """`map.slot_kernels` counts the mapping iterations whose own render
    launched the slot gather kernel: on the CPU, on either route, every
    frame records 0."""
    _, eng, _ = run
    for t in range(COUNTED):
        assert eng.frame_times[t]["counts"]["map.slot_kernels"] == 0, t


def test_boundary_frames_carry_selection_spawn_and_map_select(run):
    _, eng, _ = run
    for t in range(1, COUNTED):
        names = {s.name for s in eng.frame_times[t]["spans"]}
        at = t % BFE == 0
        for n in ("track.select", "spawn", "map.select"):
            assert (n in names) == at, (t, n)
        assert ("densify" in names) != at
        assert {"load.read", "load.stage", "track", "track.prep",
                "track.loop", "map", "map.loop"} <= names
        if not at:
            assert {"densify.edge", "densify.render",
                    "densify.candidates"} <= names


def test_pose_ready_follows_the_tracking_loops_inside_the_frame(run):
    _, eng, _ = run
    for t in range(1, COUNTED):
        spans = eng.frame_times[t]["spans"]
        (pose,) = _by_name(spans, "pose_ready")
        (track,) = _by_name(spans, "track")
        assert pose.t0 == pose.t1
        assert spans[pose.parent] == track
        assert max(s.t1 for s in _by_name(spans, "track.loop")) <= pose.t0
        assert spans[0].t0 <= pose.t0 <= track.t1 <= spans[0].t1
        # the loops and the phases that end on a synchronise say so
        assert all(s.synced for s in _by_name(spans, "track.loop"))
        assert all(s.synced for s in _by_name(spans, "map.loop"))
        assert track.synced and _by_name(spans, "map")[0].synced
        assert not any(s.synced for s in _by_name(spans, "track.cache")
                       + _by_name(spans, "map.store"))
    assert eng.stats["tracking_frame_count"] == COUNTED - 1
    assert 0 < eng.stats["tracking_frame_time_sum"] <= sum(
        eng.frame_times[t]["track"] for t in range(COUNTED))


def test_recorder_adds_no_synchronise_and_no_device_read(run):
    route, _, per = run
    assert per == PARENT_COUNTS[route]


def test_frame_span_lies_in_the_profilers_event_on_its_clock(run):
    from torch.profiler import ProfilerActivity, profile, record_function
    _, eng, _ = run
    t = COUNTED
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.frame"):
            eng.process_frame(t)
    t_start = prof.profiler.kineto_results.trace_start_ns()
    (ev,) = [e for e in prof.events() if e.name == "test.frame"]
    a = t_start + ev.time_range.start * 1000
    b = t_start + ev.time_range.end * 1000
    root = eng.frame_times[t]["spans"][0]
    assert root.name == "frame"
    assert a - 1e6 <= root.t0 <= root.t1 <= b + 1e6, (a, b, root)


def test_final_stats_drop_the_duplicate_sums(run):
    _, eng, _ = run
    s = eng.final_stats()
    assert not any(k.endswith("_incl_overhead") for k in s)
    assert not any(k in eng.stats for k in (
        "tracking_iter_time_sum", "tracking_iter_count",
        "mapping_iter_time_sum", "mapping_iter_count"))
    assert s["avg_tracking_iter_ms"] > 0 and s["avg_mapping_iter_ms"] > 0
    # every span and counter the engine sums has its stats key
    assert set(STAT_TOTALS.values()) <= set(eng.stats)


def test_trace_records_nesting_sync_marks_and_counts_outside_frames():
    stats = {"t_a": 0.0, "n": 0}
    tr = Trace(stats, {"a": "t_a", "c": "n"})
    with tr.span("a") as outside:
        tr.synced()
    tr.count("c", 2)
    assert stats["t_a"] == (outside.t1 - outside.t0) / 1e9
    assert stats["n"] == 2 and tr.record is None
    with tr.frame() as rec:
        with tr.span("a"):
            with tr.span("b"):
                tr.synced()
            tr.mark("m")
            tr.synced()
        with tr.span("d"):
            tr.synced()
            with tr.span("e"):
                pass
        tr.count("c", 3)
        tr.count("x", 1)
    names = [(s.name, s.parent, s.synced) for s in rec.spans]
    assert names == [("frame", -1, False), ("a", 0, True), ("b", 1, True),
                     ("m", 1, False), ("d", 0, False), ("e", 4, False)]
    assert rec.counts == {"c": 3, "x": 1} and stats["n"] == 5
    assert stats["t_a"] == pytest.approx(
        (outside.t1 - outside.t0 + rec.spans[1].t1 - rec.spans[1].t0) / 1e9)
    assert tr.record is None and not tr._open
