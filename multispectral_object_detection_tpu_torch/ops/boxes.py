"""Box geometry over a trailing axis of 4, batched over leading axes.

Counterparts of the box functions of
multispectral_object_detection_tpu/ops/boxes.py, with the same arithmetic:
the format conversions (``xyxy_to_xywh``, ``xywh_to_xyxy``,
``xywhn_to_xyxy``, ``xyxy_to_xywhn``), ``clip_xyxy``, ``rescale_coords``
(letterboxed canvas -> native image), the IoU matrices ``pairwise_iou``
and ``pairwise_wh_iou`` and the elementwise ``iou`` family (IoU, GIoU,
DIoU, CIoU). Layouts: ``xyxy`` corners, ``xywh`` centre and size,
``xywhn`` ``xywh`` normalised to [0, 1].
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-7


def _row(b: torch.Tensor, values) -> torch.Tensor:
    """``values`` as a tensor in ``b``'s floating dtype (float32 at least)
    and on its device, to broadcast over its trailing axis."""
    return torch.tensor(values, dtype=torch.promote_types(b.dtype,
                                                          torch.float32),
                        device=b.device)


def xyxy_to_xywh(b: torch.Tensor) -> torch.Tensor:
    """[..., 4] corners -> centers+sizes."""
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1],
                       dim=-1)


def xywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    """[..., 4] centers+sizes -> corners."""
    cx, cy, w, h = b.unbind(-1)
    hw, hh = w * 0.5, h * 0.5
    return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], dim=-1)


def xywhn_to_xyxy(b: torch.Tensor, w: float, h: float, padw: float = 0.0,
                  padh: float = 0.0) -> torch.Tensor:
    """Normalised centers+sizes -> pixel corners on a (h, w) canvas,
    shifted by (padw, padh)."""
    return xywh_to_xyxy(b) * _row(b, [w, h, w, h]) + _row(
        b, [padw, padh, padw, padh])


def xyxy_to_xywhn(b: torch.Tensor, w: float, h: float) -> torch.Tensor:
    """Pixel corners -> normalised centers+sizes."""
    return xyxy_to_xywh(b) * _row(b, [1.0 / w, 1.0 / h, 1.0 / w, 1.0 / h])


def clip_xyxy(b: torch.Tensor, height: float, width: float) -> torch.Tensor:
    """Corners clamped into a (height, width) image."""
    return torch.minimum(b.clamp(min=0.0),
                         _row(b, [width, height, width, height]))


def rescale_coords(coords: torch.Tensor, src_hw, dst_hw,
                   ratio_pad=None) -> torch.Tensor:
    """xyxy on a letterboxed ``src_hw`` canvas -> the ``dst_hw`` image:
    the centred pad taken off, divided by the letterbox gain, clipped.
    ratio_pad: ((gain, gain), (padw, padh)) as the loader recorded it, or
    None to derive both from the two shapes."""
    if ratio_pad is None:
        gain = min(src_hw[0] / dst_hw[0], src_hw[1] / dst_hw[1])
        padw = (src_hw[1] - dst_hw[1] * gain) / 2
        padh = (src_hw[0] - dst_hw[0] * gain) / 2
    else:
        gain = ratio_pad[0][0]
        padw, padh = ratio_pad[1]
    out = (coords - _row(coords, [padw, padh, padw, padh])) / gain
    return clip_xyxy(out, dst_hw[0], dst_hw[1])


def pairwise_iou(a: torch.Tensor, b: torch.Tensor,
                 eps: float = _EPS) -> torch.Tensor:
    """IoU matrix between xyxy sets: a [..., N, 4], b [..., M, 4] -> [..., N, M]."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = torch.prod((rb - lt).clamp(min=0.0), dim=-1)
    area_a = torch.prod(a[..., 2:] - a[..., :2], dim=-1)
    area_b = torch.prod(b[..., 2:] - b[..., :2], dim=-1)
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter + eps)


def pairwise_wh_iou(wh1: torch.Tensor, wh2: torch.Tensor) -> torch.Tensor:
    """IoU matrix of (w, h) pairs as if their boxes shared a corner:
    wh1 [..., N, 2], wh2 [..., M, 2] -> [..., N, M]."""
    inter = torch.prod(torch.minimum(wh1[..., :, None, :],
                                     wh2[..., None, :, :]), dim=-1)
    a1 = torch.prod(wh1, dim=-1)[..., :, None]
    a2 = torch.prod(wh2, dim=-1)[..., None, :]
    return inter / (a1 + a2 - inter)


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
