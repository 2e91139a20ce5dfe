"""The readers of the program's spans and counters (`spans.py`) on a
synthetic window with known spans and counts, a program that records none,
and a tiny traced run on the CPU."""
import pytest
import torch

from portbench.harness import session
from portbench.harness.spec import metric_reader
from portbench.tests.tiny import run_tiny

READERS = {"ms_per_iter.track": "ms", "ms_per_iter.map": "ms",
           "densify_s.edge": "s", "densify_s.render": "s",
           "densify_s.candidates": "s", "map_binnings_per_frame": "binnings"}
US = 1000          # ns


def span(name, a, b, parent=0, synced=False):
    """A span as the program records it, times in us."""
    return (name, a * US, b * US, parent, synced)


def frame(t, boundary=False, window=True, spans=True):
    """Frame t: track [0, 400] with its loop [40, 360] (4 iterations, 2 on
    a boundary), densify [400, 600] (edge 150, render 20, candidates
    10 + 20) on other frames, map [600, 1000] with its loop [620, 970]
    (5 iterations, 3 binnings built)."""
    sp = [span("frame", 0, 1000, -1), span("track", 0, 400, 0, True),
          span("track.loop", 40, 360, 1, True)]
    if not boundary:
        sp += [span("densify", 400, 600, 0, True),
               span("densify.edge", 400, 550, 3),
               span("densify.render", 550, 570, 3),
               span("densify.candidates", 570, 580, 3),
               span("densify.candidates", 580, 600, 3)]
    at = len(sp)
    sp += [span("map", 600, 1000, 0, True),
           span("map.loop", 620, 970, at, True)]
    counts = {"track.iters": 2 if boundary else 4, "map.iters": 5,
              "map.binnings_built": 3}
    times = {"spans": sp, "counts": counts} if spans else {}
    return dict(t=t, wall_s=0.001, times=times, boundary=boundary,
                window=window)


def window(**kw):
    win = session.Window("room0.scan", bfe=40, split=5)
    win.frames = [frame(t, **kw) for t in (2, 3)] + [
        frame(5, **kw), frame(40, boundary=True, window=False, **kw)]
    return win


def read(name, win):
    return metric_reader(name)(win)


def test_readers_on_known_spans_and_counts():
    win = window()
    # frames 2 and 3 are timed (5 is the check's split, 40 after the window)
    assert read("ms_per_iter.track", win) == pytest.approx(2 * 0.320 / 8)
    assert read("ms_per_iter.map", win) == pytest.approx(2 * 0.350 / 10)
    assert read("densify_s.edge", win) == pytest.approx(150e-6)
    assert read("densify_s.render", win) == pytest.approx(20e-6)
    assert read("densify_s.candidates", win) == pytest.approx(30e-6)
    assert read("map_binnings_per_frame", win) == 3
    # a boundary in the window: its loop and iterations count, its
    # densification (none) leaves the per-frame mean
    win.frames.append(frame(4, boundary=True))
    assert read("ms_per_iter.track", win) == pytest.approx(3 * 0.320 / 10)
    assert read("densify_s.edge", win) == pytest.approx(150e-6)


def test_nothing_where_the_program_records_no_spans():
    win = window(spans=False)
    assert all(read(n, win) is None for n in READERS)
    # spans but no synced loop
    win = window()
    for f in win.frames:
        f["times"]["spans"] = [s[:4] + (False,) if s[0].endswith(".loop")
                               else s for s in f["times"]["spans"]]
    assert read("ms_per_iter.map", win) is None
    assert read("densify_s.edge", win) is not None


def test_a_traced_tiny_run_reads_the_spans_and_counters(tmp_path):
    """The program's spans and counters reach the readers of a whole run
    (the CPU: no device trace)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        r = run_tiny("room0.scan", tmp_path, trace=True, min_frames=3)
    finally:
        torch.set_num_threads(threads)
    assert r["correct"], r["check"]
    m = r["metrics"]
    for name, unit in READERS.items():
        assert m[name]["value"] > 0 and m[name]["unit"] == unit, name
    assert "device_idle" not in m
