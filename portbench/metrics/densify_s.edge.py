"""densify_s.edge: mean seconds per window frame that is not a section
boundary of the program's `densify.edge` span: the host's edge mask of the
frame (numpy's Canny), before anything of densification reaches the card."""
from portbench.harness import spans


def read(run):
    return spans.seconds_per_frame(run, "densify.edge")
