"""map_slot_kernel_iters: mapping iterations a window frame ran with its
render's rows gathered by the program's slot kernels (the
`map.slot_kernels` counter: every binned mapping iteration on a card, 0
where the gather ran as PyTorch ops). A program without the counter reads
nothing."""
from portbench.harness import spans


def read(run):
    return spans.per_frame(run, "map.slot_kernels")
