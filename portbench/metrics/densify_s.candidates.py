"""densify_s.candidates: mean seconds per window frame that is not a section
boundary of the program's `densify.candidates` span: the host's masks and
pixel compaction at the frame's and the densification stream's sizes, the
stream's frame, and the new points' enqueue."""
from portbench.harness import spans


def read(run):
    return spans.seconds_per_frame(run, "densify.candidates")
