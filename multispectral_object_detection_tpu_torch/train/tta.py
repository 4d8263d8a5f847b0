"""Test-time augmentation inference.

Counterpart of multispectral_object_detection_tpu/train/tta.py: three
scales (1, 0.83, 0.67) with flips (none, left-right, none), both modalities
(or the one of a single-stream model) scaled and flipped together, the
decoded boxes mapped back to the original canvas and concatenated.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.attention import bilinear_resize_2d

SCALES = (1.0, 0.83, 0.67)
FLIPS = (None, "lr", None)


def _scale_img(x: torch.Tensor, scale: float, gs: int = 32) -> torch.Tensor:
    """(B, C, H, W) resized to int(H * scale) x int(W * scale) (bilinear,
    align_corners=False) and padded at the bottom and right with gray 0.447
    up to a multiple of ``gs``."""
    h, w = x.shape[2], x.shape[3]
    nh, nw = int(h * scale), int(w * scale)
    y = bilinear_resize_2d(x, (nh, nw))
    ph, pw = (gs - nh % gs) % gs, (gs - nw % gs) % gs
    if ph or pw:
        y = F.pad(y, (0, pw, 0, ph), value=0.447)
    return y


def tta_forward(model, rgb: torch.Tensor, ir: Optional[torch.Tensor] = None,
                gs: int = 32) -> torch.Tensor:
    """Augmented inference on (B, 3, H, W) inputs in [0, 1] (``ir`` None
    for a single-stream model): decoded detections (B, sum_i N_i, 5+nc) in
    the original canvas frame."""
    w = rgb.shape[3]
    outs = []
    for scale, flip in zip(SCALES, FLIPS):
        ins = [rgb] if ir is None else [rgb, ir]
        if flip == "lr":
            ins = [t.flip(-1) for t in ins]
        if scale != 1.0:
            ins = [_scale_img(t, scale, gs) for t in ins]
        ins = [t.contiguous(memory_format=torch.channels_last) for t in ins]
        d = model.decode(model(*ins))  # (B, N, 5+nc), xywh in scaled pixels
        xy = d[..., :2] / scale
        wh = d[..., 2:4] / scale
        if flip == "lr":
            xy = torch.stack([w - xy[..., 0], xy[..., 1]], dim=-1)
        outs.append(torch.cat([xy, wh, d[..., 4:]], dim=-1))
    return torch.cat(outs, dim=1)
