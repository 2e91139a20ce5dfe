"""device_idle: the share of the wall time of the profiled window frames
in which no operation runs on the card (one minus the union of the
device operations' intervals over the frames' spans), in %."""


def read(run):
    d = run.device
    if not d or d["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
