"""Work counts kept with the benchmark: FLOPs per pair and per train step,
and the FLOPs and bytes of each kind of launch of the CFT stack (K1).

Counted from the cell's shapes, or by ``FlopCounterMode`` over the
benchmark's own reference model on the meta device (nothing is computed),
never over the program, so a later change to the program's kernels or
convolutions leaves the yardstick where it is. ``FlopCounterMode`` counts
matrix products and convolutions at 2 FLOPs per multiply-add; norms,
activations, pooling and resizing are not counted.

K1 per layer of width C over M = B x 128 tokens, as the port's kernel
table bounds it: each input byte read once and each output byte written
once, the fp32 residual stream read and written by the residual GEMMs,
LayerNorm's 8 operations per element against the fp32 peak and the rest
against the bf16 peak.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .reference.model import GPT, ReferenceModel

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())
TOKENS = 2 * GPT.GRID ** 2  # 128: two 8 x 8 grids
HEADS, LAYERS = GPT.HEADS, GPT.LAYERS


def peaks(kind: str) -> Optional[dict]:
    """The published peaks of a card, by ``torch.cuda.get_device_name``."""
    return PEAKS["cards"].get(kind)


def _meta_model(cfg: dict) -> ReferenceModel:
    with torch.device("meta"):
        return ReferenceModel(cfg)


def cft_widths(cfg: dict) -> List[int]:
    """Widths C of the configuration's CFT stages, in row order."""
    return [m.pos_emb.shape[-1] for m in _meta_model(cfg).modules()
            if isinstance(m, GPT)]


def flops_per_pair(cfg: dict, hw: Tuple[int, int]) -> float:
    """Inference FLOPs of one RGB + IR pair at (H, W)."""
    from torch.utils.flop_counter import FlopCounterMode

    model = _meta_model(cfg).eval()
    x = torch.zeros((1, 3) + tuple(hw), device="meta")
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(x, x)
    return float(counter.get_total_flops())


def train_flops_per_step(cfg: dict, batch: int, hw: Tuple[int, int]) -> float:
    """FLOPs of one train step's forward and backward at ``batch`` pairs:
    the training-mode forward and the gradients of every parameter (the
    backward of a product counts its two products)."""
    from torch.utils.flop_counter import FlopCounterMode

    model = _meta_model(cfg).train()
    x = torch.zeros((batch, 3) + tuple(hw), device="meta")
    counter = FlopCounterMode(display=False)
    with counter:
        out = model(x, x)
        loss = sum(o.float().sum() for o in out)
        torch.autograd.grad(loss, [p for p in model.parameters()
                                   if p.requires_grad])
    return float(counter.get_total_flops())


def _gemm(m: int, k: int, n: int, residual: bool) -> Tuple[float, float]:
    """(bytes, FLOPs) of one bf16 GEMM with bias (+ an fp32 residual)."""
    by = 2 * (m * k + k * n + n) + (8 if residual else 2) * m * n
    return by, 2 * m * k * n + m * n


def k1_launches(batch: int, widths: Sequence[int], layers: int = LAYERS,
                heads: int = HEADS, tokens: int = TOKENS
                ) -> Dict[str, List[Tuple[float, float, str]]]:
    """{kind of launch: [(bytes, FLOPs, peak), ...]} of one forward's K1
    launches at ``batch`` pairs; ``peak`` is "bf16" or "fp32"."""
    m = batch * tokens
    out: Dict[str, list] = {k: [] for k in (
        "layernorm", "gemm_bias", "gemm_gelu", "gemm_residual", "attention")}
    for c in widths:
        for _ in range(layers):
            out["layernorm"] += [(m * c * 4 + m * c * 2 + 2 * c * 4,
                                  8 * m * c, "fp32")] * 2
            out["gemm_bias"].append((*_gemm(m, c, 3 * c, False), "bf16"))
            out["gemm_gelu"].append((*_gemm(m, c, 4 * c, False), "bf16"))
            out["gemm_residual"] += [(*_gemm(m, c, c, True), "bf16"),
                                     (*_gemm(m, 4 * c, c, True), "bf16")]
            out["attention"].append((m * 4 * c * 2, 4 * m * tokens * c
                                     + 5 * batch * heads * tokens ** 2,
                                     "bf16"))
    return out


def bound_ms(launches, card: dict) -> float:
    """Least time for the launches: per launch the larger of its bytes at
    the memory peak and its FLOPs at the compute peak, summed."""
    total = 0.0
    for by, fl, peak in launches:
        total += max(by / card["hbm_bytes_per_s"],
                     fl / card[f"{peak}_flops_per_s"]) * 1e3
    return total


def k1_bound_ms(batch: int, widths: Sequence[int], card: dict) -> float:
    """Least time for one forward's K1 work at ``batch`` pairs."""
    return sum(bound_ms(v, card) for v in k1_launches(batch, widths).values())
