"""msda_roofline.detr: the least time for one call's MSDA work at the
cell's shapes (``work_detr.msda_bound_ms``: per sampling call the larger
of its bytes at the memory peak and its FLOPs at the bf16 peak), in % of
``msda_ms.detr``."""

from portbench.work import peaks
from portbench.work_detr import msda_bound_ms


def read(ctx):
    card = peaks(ctx["device"]["kind"])
    ms = (ctx.get("span_ms") or {}).get("msda")
    if card is None or not ms:
        return None
    return 100.0 * msda_bound_ms(ctx["cfg"], ctx["batch"], ctx["hw"],
                                 card) / ms
