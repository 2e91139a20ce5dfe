"""map_binnings_per_frame: keyframe binnings the mapping phase built per
window frame (the program's `map.binnings_built` counter: the new
keyframe's, the refreshed ones, and every slot when the store's key
changes)."""
from portbench.harness import spans


def read(run):
    return spans.per_frame(run, "map.binnings_built")
