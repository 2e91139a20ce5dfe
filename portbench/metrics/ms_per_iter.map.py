"""ms_per_iter.map: ms per mapping iteration over the timed window frames:
the seconds of the program's `map.loop` spans (each ends on a synchronise)
over its `map.iters` counter."""
from portbench.harness import spans


def read(run):
    return spans.ms_per_iter(run, "map.loop", "map.iters")
