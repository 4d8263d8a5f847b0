"""Multi-scale deformable attention's sampling (Deformable DETR's MSDA core).

Each query of each head reads ``points`` positions in every level of a
multi-level value map, at its reference point plus offsets that its own
features chose, and sums the bilinear samples with softmax weights:

    loc = r + offset / (W_l, H_l)                     (fp32)
    a   = softmax over the (level, point) pairs of the logits   (fp32)
    out = sum_{l, p} a * bilinear(V_l, loc)           (fp32 accumulation)

``bilinear`` has ``grid_sample``'s semantics (align_corners False, zeros
outside). One ``grid_sample`` per level, on the level's value in fp32 laid
out channels last (each head's 32 channels of a pixel in one 128-byte
line), so the sampling addresses come from the data but no level waits on
the host: level shapes are Python ints and nothing is read back. The
projections around it (value, offsets, weights, output) are the caller's.

One ``msda`` span per call (utils/tracing); counters ``msda.calls`` and
``msda.samples`` (queries x heads x levels x points).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..utils.tracing import count, span


def ms_deform_attn(value: torch.Tensor, shapes: Sequence[Tuple[int, int]],
                   reference: torch.Tensor, offsets: torch.Tensor,
                   logits: torch.Tensor, points: int) -> torch.Tensor:
    """value (N, S, M, D) with S = sum of H_l * W_l, levels in order;
    reference (N or 1, Q, 2) as (x, y) in [0, 1], the same at every level;
    offsets (N, Q, M * L * P * 2) in pixels of each level, (x, y) last;
    logits (N, Q, M * L * P) -> (N, Q, M * D) in value's dtype."""
    with span("msda"):
        n, q = offsets.shape[:2]
        m, d = value.shape[2:]
        nl = len(shapes)
        count("msda.calls")
        count("msda.samples", n * q * m * nl * points)
        off = offsets.float().view(n, q, m, nl, points, 2)
        a = logits.float().view(n, q, m, nl * points).softmax(-1)
        a = a.view(n, q, m, nl, points)
        ref = reference.float()[:, :, None, None, :]
        out, start = None, 0
        for lid, (h, w) in enumerate(shapes):
            o = off[:, :, :, lid]
            loc = ref + torch.stack((o[..., 0] / w, o[..., 1] / h), -1)
            grid = (2 * loc - 1).transpose(1, 2).reshape(n * m, q, points, 2)
            v = value.new_empty((n, m, h * w, d), dtype=torch.float32)
            v.copy_(value[:, start:start + h * w].transpose(1, 2))
            v = v.view(n * m, h, w, d).permute(0, 3, 1, 2)
            s = F.grid_sample(v, grid, mode="bilinear", padding_mode="zeros",
                              align_corners=False)  # (N * M, D, Q, P)
            wl = a[:, :, :, lid].transpose(1, 2).reshape(n * m, 1, q, points)
            part = s.mul_(wl).sum(-1)  # (N * M, D, Q)
            out = part if out is None else out.add_(part)
            start += h * w
        return out.view(n, m * d, q).transpose(1, 2).to(value.dtype)
