"""k1_roofline.serve: the least time for one call's K1 work at the cell's
shapes (``work.k1_bound_ms``: per launch the larger of bytes at the memory
peak and FLOPs at the compute peak), in % of the device time of the
kernels that ``k1_roofline.serve.json`` names, per traced call."""

from portbench.metrics._kind import kind_ms
from portbench.work import cft_widths, k1_bound_ms, peaks


def read(ctx):
    card = peaks(ctx["device"]["kind"])
    ms = kind_ms(ctx, "k1_roofline.serve")
    if card is None or ms is None:
        return None
    return 100.0 * k1_bound_ms(ctx["batch"], cft_widths(ctx["cfg"]), card) / ms
