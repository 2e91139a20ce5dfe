"""What the per-layer readers read of the program's own spans and counters.

The port records, per frame, its spans (`frame_times[t]["spans"]`: name,
t0, t1 in ns of `time.time_ns()`, parent index, synced) and its counters
(`frame_times[t]["counts"]`). A program without them (an older port) gives
no spans and no counts, and every reading here is then None.
"""
from __future__ import annotations


def frame_spans(frame: dict) -> list:
    """A window frame's spans (empty where the program records none)."""
    return list(frame["times"].get("spans") or [])


def named(frames, name: str) -> list:
    """Every span called `name` over the frames."""
    return [s for f in frames for s in frame_spans(f) if s[0] == name]


def ms_per_iter(run, loop: str, counter: str) -> float | None:
    """ms per iteration over the timed frames: the synced `loop` spans'
    seconds over the `counter` iterations."""
    frames = run.timed()
    iters = sum(f["times"].get("counts", {}).get(counter, 0) for f in frames)
    loops = [s for s in named(frames, loop) if s[4]]
    if iters <= 0 or not loops:
        return None
    return sum(s[2] - s[1] for s in loops) / 1e6 / iters


def seconds_per_frame(run, name: str) -> float | None:
    """Mean seconds a timed frame that is not a section boundary spends in
    the spans called `name`, over the frames that record spans."""
    frames = [f for f in run.timed() if not f["boundary"] and frame_spans(f)]
    spans = named(frames, name)
    if not spans:
        return None
    return sum(s[2] - s[1] for s in spans) / 1e9 / len(frames)


def per_frame(run, counter: str) -> float | None:
    """Mean of the `counter` a timed frame records, over the frames that
    record counters (None where none records this one)."""
    counts = [f["times"].get("counts") for f in run.timed()]
    counts = [c for c in counts if c]
    if not any(counter in c for c in counts):
        return None
    return sum(c.get(counter, 0) for c in counts) / len(counts)
