"""The reader of `track_graph_iters` (the program's `track.graph_iters`
counter) on a synthetic window, a program that records no such counter,
and a tiny traced run on the CPU, where no tracking loop is graphed."""
import torch

from portbench.tests.test_portbench_spans import read, window
from portbench.tests.tiny import run_tiny


def test_graph_iterations_per_frame_and_nothing_without_the_counter():
    """`track_graph_iters` is the mean of the frames' `track.graph_iters`
    (a frame that records counters but not this one counts 0); a program
    without the counter, as before the tracking loop had a graph, reads
    nothing."""
    win = window()
    assert read("track_graph_iters", win) is None
    for f, n in zip(win.frames, (79, 77, 76, 0)):
        f["times"]["counts"]["track.graph_iters"] = n
    # frames 2 and 3 are timed; the split (5) and frame 40 are not
    assert read("track_graph_iters", win) == 78
    del win.frames[1]["times"]["counts"]["track.graph_iters"]
    assert read("track_graph_iters", win) == 79 / 2
    assert read("track_graph_iters", window(spans=False)) is None


def test_a_traced_tiny_run_reads_no_graphed_iteration(tmp_path):
    """The CPU replays no graph: every cached tracking iteration of a whole
    run is eager, and the metric reads 0 (not nothing)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        r = run_tiny("room0.scan", tmp_path, trace=True, min_frames=3)
    finally:
        torch.set_num_threads(threads)
    assert r["correct"], r["check"]
    assert r["metrics"]["track_graph_iters"] == {"value": 0,
                                                 "unit": "iterations"}
