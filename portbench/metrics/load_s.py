"""load_s: mean seconds per window frame spent reading the frame from its
files and staging it on the card (`timers` t_dataset + t_stage of
`frame_times[t]`, the program's host clock)."""


def read(run):
    fr = run.timed()
    if not fr:
        return None
    return sum(f["times"]["timers"].get("t_dataset", 0.0)
               + f["times"]["timers"].get("t_stage", 0.0) for f in fr) / len(fr)
