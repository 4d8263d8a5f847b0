"""mfu.infer: the benchmark's FLOPs per pair (``work.flops_per_pair``, over
the reference model at the cell's input size) times the run's pairs/s, in
% of the card's dense bf16 peak."""

from portbench.work import peaks


def read(ctx):
    card = peaks(ctx["device"]["kind"])
    if card is None:
        return None
    return 100.0 * ctx["flops_per_pair"] * ctx["pairs_per_s"] \
        / card["bf16_flops_per_s"]
