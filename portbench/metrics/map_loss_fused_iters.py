"""map_loss_fused_iters: mapping iterations a window frame ran with its
loss in the program's mapping-loss kernel (the `map.loss_fused` counter:
every mapping iteration on a card, 0 where the loss ran as PyTorch ops).
A program without the counter reads nothing."""
from portbench.harness import spans


def read(run):
    return spans.per_frame(run, "map.loss_fused")
