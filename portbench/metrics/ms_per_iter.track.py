"""ms_per_iter.track: ms per tracking iteration over the timed window
frames: the seconds of the program's `track.loop` spans (each ends on a
synchronise) over its `track.iters` counter (iterations run, the depth-loss
rerun and every boundary candidate's included)."""
from portbench.harness import spans


def read(run):
    return spans.ms_per_iter(run, "track.loop", "track.iters")
