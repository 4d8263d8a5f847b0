"""mfu.train: the benchmark's FLOPs per train step (``work.
train_flops_per_step``, forward and backward over the reference model at
the cell's batch and canvas) times the run's steps/s, in % of the card's
dense bf16 peak."""

from portbench.work import peaks


def read(ctx):
    card = peaks(ctx["device"]["kind"])
    if card is None:
        return None
    return 100.0 * ctx["train_flops_per_step"] * ctx["steps_per_s"] \
        / card["bf16_flops_per_s"]
