"""densify_s.render: mean seconds per window frame that is not a section
boundary of the program's `densify.render` span: the non-presence render
(K4) and the read of its mask to the host, which waits for it."""
from portbench.harness import spans


def read(run):
    return spans.seconds_per_frame(run, "densify.render")
