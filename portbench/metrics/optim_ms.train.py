"""optim_ms.train: device ms per traced call of the kernels that `optim_ms.train.json` names."""

from portbench.metrics._kind import kind_ms


def read(ctx):
    return kind_ms(ctx, "optim_ms.train")
