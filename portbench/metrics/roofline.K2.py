"""roofline.K2: the least time of one K2 launch of the window (the first
of frame 4), as `portbench/harness/roofline.py` counts it from the
launch's inputs, over its time (CUDA events, median of 10), in %."""


def read(run):
    k = run.kernels.get("K2")
    if not k or k["time_s"] <= 0:
        return None
    return 100.0 * k["bound_s"] / k["time_s"]
