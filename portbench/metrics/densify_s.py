"""densify_s: mean seconds of densification per window frame that is not
a section boundary (`frame_times[t]["densify"]`; a boundary frame spawns
a section instead)."""


def read(run):
    fr = [f for f in run.timed() if not f["boundary"]]
    if not fr:
        return None
    return sum(f["times"]["densify"] for f in fr) / len(fr)
