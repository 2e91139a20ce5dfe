"""track_s: mean seconds per window frame of the track phase
(`frame_times[t]["track"]`, the program's host clock around work that
ends in a synchronise)."""


def read(run):
    fr = run.timed()
    if not fr:
        return None
    return sum(f["times"]["track"] for f in fr) / len(fr)
