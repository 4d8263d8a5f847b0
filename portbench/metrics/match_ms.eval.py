"""match_ms.eval: the evaluator's own `t_match_ms` (ms per image), averaged over the
window's passes."""


def read(ctx):
    ev = ctx.get("evaluator")
    return None if ev is None else ev["t_match_ms"]
