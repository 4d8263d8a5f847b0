"""Device ms per traced call of one kind of kernel, by the metric's
pattern file (``<metric>.json``: an ordered table of kinds and the kind
that the metric reads)."""

from __future__ import annotations

from typing import Optional

from portbench.harness import kinds_ms, patterns


def kind_ms(ctx: dict, metric: str) -> Optional[float]:
    p = patterns(metric)
    ms = kinds_ms(ctx["trace"], p["kinds"])[p["kind"]]
    return ms if ms > 0 else None
