"""memcpy_ms.serve: device ms per traced call of the kernels that `memcpy_ms.serve.json` names."""

from portbench.metrics._kind import kind_ms


def read(ctx):
    return kind_ms(ctx, "memcpy_ms.serve")
