"""nms_ms.eval: the evaluator's own `t_nms_ms` (ms per image), averaged over the
window's passes."""


def read(ctx):
    ev = ctx.get("evaluator")
    return None if ev is None else ev["t_nms_ms"]
