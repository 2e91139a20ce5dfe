"""spawn_s: mean seconds per boundary frame of spawning its section
(`frame_times[t]["spawn"]`), over the boundaries of the window and of the
frames run on after it for the check (the check's hooks there only keep
references); nothing where neither holds a boundary."""


def read(run):
    fr = [f for f in run.unhooked() if f["boundary"]]
    if not fr:
        return None
    return sum(f["times"]["spawn"] for f in fr) / len(fr)
