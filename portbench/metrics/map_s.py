"""map_s: mean seconds per window frame of the map phase
(`frame_times[t]["map"]`, the program's host clock around work that
ends in a synchronise)."""


def read(run):
    fr = run.timed()
    if not fr:
        return None
    return sum(f["times"]["map"] for f in fr) / len(fr)
