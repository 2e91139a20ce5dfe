"""The reader of `map_slot_kernel_iters` (the program's `map.slot_kernels`
counter) on a synthetic window, a program that records no such counter,
and a tiny traced run on the CPU, where no render takes the slot kernels."""
import torch

from portbench.tests.test_portbench_spans import read, window
from portbench.tests.tiny import run_tiny


def test_slot_kernel_iterations_per_frame_and_nothing_without_the_counter():
    """`map_slot_kernel_iters` is the mean of the timed frames'
    `map.slot_kernels` (a frame that records counters but not this one
    counts 0); a program without the counter, as before the slot kernels,
    reads nothing."""
    win = window()
    assert read("map_slot_kernel_iters", win) is None
    for f, n in zip(win.frames, (100, 100, 100, 0)):
        f["times"]["counts"]["map.slot_kernels"] = n
    # frames 2 and 3 are timed; the split (5) and frame 40 are not
    assert read("map_slot_kernel_iters", win) == 100
    del win.frames[1]["times"]["counts"]["map.slot_kernels"]
    assert read("map_slot_kernel_iters", win) == 50
    assert read("map_slot_kernel_iters", window(spans=False)) is None


def test_a_traced_tiny_run_reads_no_slot_kernel_iteration(tmp_path):
    """The CPU gathers the slots as PyTorch ops: the metric reads 0 (not
    nothing)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        r = run_tiny("room0.scan", tmp_path, trace=True, min_frames=3)
    finally:
        torch.set_num_threads(threads)
    assert r["correct"], r["check"]
    assert r["metrics"]["map_slot_kernel_iters"] == {"value": 0,
                                                     "unit": "iterations"}
