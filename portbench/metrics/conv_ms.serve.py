"""conv_ms.serve: device ms per traced call of the kernels that `conv_ms.serve.json` names."""

from portbench.metrics._kind import kind_ms


def read(ctx):
    return kind_ms(ctx, "conv_ms.serve")
