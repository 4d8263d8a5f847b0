"""Box geometry over a trailing axis of 4, batched over leading axes.

Counterparts of ``xywh_to_xyxy``, ``pairwise_iou`` and the elementwise
``iou`` family (IoU, GIoU, DIoU, CIoU) in
multispectral_object_detection_tpu/ops/boxes.py, with the same arithmetic.
"""

from __future__ import annotations

import math

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


def _corners(b: torch.Tensor, is_xyxy: bool):
    if is_xyxy:
        return b.unbind(-1)
    cx, cy, w, h = b.unbind(-1)
    return cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5


def iou(b1: torch.Tensor, b2: torch.Tensor, xyxy: bool = True,
        kind: str = "iou", eps: float = _EPS) -> torch.Tensor:
    """Elementwise IoU / GIoU / DIoU / CIoU between equally shaped boxes:
    ``+eps`` on the heights and the union, and the CIoU trade-off
    ``alpha = v / (v - iou + 1 + eps)`` without a gradient."""
    ax1, ay1, ax2, ay2 = _corners(b1, xyxy)
    bx1, by1, bx2, by2 = _corners(b2, xyxy)
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp(min=0.0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp(min=0.0)
    inter = iw * ih
    w1, h1 = ax2 - ax1, ay2 - ay1 + eps
    w2, h2 = bx2 - bx1, by2 - by1 + eps
    union = w1 * h1 + w2 * h2 - inter + eps
    i = inter / union
    if kind == "iou":
        return i
    cw = torch.maximum(ax2, bx2) - torch.minimum(ax1, bx1)
    ch = torch.maximum(ay2, by2) - torch.minimum(ay1, by1)
    if kind == "giou":
        c_area = cw * ch + eps
        return i - (c_area - union) / c_area
    c2 = cw * cw + ch * ch + eps
    rho2 = ((bx1 + bx2 - ax1 - ax2) ** 2 + (by1 + by2 - ay1 - ay2) ** 2) * 0.25
    if kind == "diou":
        return i - rho2 / c2
    if kind == "ciou":
        v = (4.0 / math.pi ** 2) * (torch.atan(w2 / h2)
                                    - torch.atan(w1 / h1)) ** 2
        with torch.no_grad():
            alpha = v / (v - i + (1.0 + eps))
        return i - (rho2 / c2 + v * alpha)
    raise ValueError(f"unknown IoU kind: {kind}")
