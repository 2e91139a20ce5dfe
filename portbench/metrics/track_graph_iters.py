"""track_graph_iters: tracking iterations a window frame served by
replaying its loop's CUDA graph (the program's `track.graph_iters`
counter: every iteration of a cached tracking call after its first, on a
card). A program without the counter reads nothing."""
from portbench.harness import spans


def read(run):
    return spans.per_frame(run, "track.graph_iters")
