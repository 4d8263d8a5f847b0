"""Seeds derived from the run's ``--seed``: one stream per purpose, so that
inputs, weights and samples never share draws."""

from __future__ import annotations

import hashlib

MASK63 = (1 << 63) - 1


def derive(seed: int, purpose: str) -> int:
    """A 63-bit seed for ``purpose`` from any whole number ``seed``."""
    h = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(h[:8], "little") & MASK63
