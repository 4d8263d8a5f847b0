"""Work counts of the Deformable DETR cell, kept with the benchmark: FLOPs
per image and the bytes and FLOPs of each call of multi-scale deformable
attention's sampling (MSDA).

Counted from the configuration's shapes, or by ``FlopCounterMode`` over
the benchmark's own reference (``reference/deformable_detr``) on the meta
device, never over the program. ``FlopCounterMode`` counts convolutions
and matrix products at 2 FLOPs per multiply-add; ``grid_sample`` (the
sampling), norms, softmax and activations are not counted.

MSDA per call, Q queries over a value map of S tokens and C channels
(M heads, L levels, P points), batch B: the value tensor read once in the
configuration's dtype, the fp32 sampling locations (2 a sample) and
weights (1 a sample) read once, the output written once in the
configuration's dtype; 10 FLOPs a channel-sample (the bilinear's four
weights and three adds per channel, the weight's multiply and the
accumulation). Six encoder calls (Q = S) and six decoder calls
(Q = the queries) a forward.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from .reference.deformable_detr import DeformableDETR, level_shapes
from .work import bound_ms


def flops_per_image(cfg: dict, hw: Tuple[int, int]) -> float:
    """Inference FLOPs of one image at (H, W) over the reference."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        model = DeformableDETR(cfg).eval()
    model.requires_grad_(False)
    x = torch.zeros((1, 3) + tuple(hw), device="meta")
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(x)
    return float(counter.get_total_flops())


def msda_calls(cfg: dict, batch: int, hw: Tuple[int, int]
               ) -> List[Tuple[float, float, str]]:
    """[(bytes, FLOPs, peak)] of one forward's MSDA calls at ``batch``
    images of (H, W), encoder first."""
    itemsize = getattr(torch, cfg["dtype"]).itemsize
    c, m = cfg["hidden_dim"], cfg["nheads"]
    s = sum(h * w for h, w in level_shapes(hw))
    nl = cfg["num_feature_levels"]
    out = []
    for q, p, n in ((s, cfg["enc_n_points"], cfg["enc_layers"]),
                    (cfg["num_queries"], cfg["dec_n_points"],
                     cfg["dec_layers"])):
        samples = batch * q * m * nl * p
        by = itemsize * batch * s * c + 4 * 3 * samples \
            + itemsize * batch * q * c
        out += [(by, 10.0 * samples * (c // m), "bf16")] * n
    return out


def msda_bound_ms(cfg: dict, batch: int, hw: Tuple[int, int],
                  card: dict) -> float:
    """Least time for one forward's MSDA work: per call the larger of its
    bytes at the memory peak and its FLOPs at the bf16 peak, summed."""
    return bound_ms(msda_calls(cfg, batch, hw), card)
