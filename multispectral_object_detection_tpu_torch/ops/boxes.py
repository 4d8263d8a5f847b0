"""Box geometry over a trailing axis of 4, batched over leading axes.

Counterparts of ``xywh_to_xyxy`` and ``pairwise_iou`` in
multispectral_object_detection_tpu/ops/boxes.py, with the same arithmetic.
"""

from __future__ import annotations

import torch

_EPS = 1e-7


def xywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    """[..., 4] centers+sizes -> corners."""
    cx, cy, w, h = b.unbind(-1)
    hw, hh = w * 0.5, h * 0.5
    return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], dim=-1)


def pairwise_iou(a: torch.Tensor, b: torch.Tensor,
                 eps: float = _EPS) -> torch.Tensor:
    """IoU matrix between xyxy sets: a [..., N, 4], b [..., M, 4] -> [..., N, M]."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = torch.prod((rb - lt).clamp(min=0.0), dim=-1)
    area_a = torch.prod(a[..., 2:] - a[..., :2], dim=-1)
    area_b = torch.prod(b[..., 2:] - b[..., :2], dim=-1)
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter + eps)
