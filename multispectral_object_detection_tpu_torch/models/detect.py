"""Anchor-based detection head and its decode.

Counterpart of multispectral_object_detection_tpu/models/detect.py. The head
maps pyramid features to raw per-scale logits in the JAX package's layout,
(B, ny, nx, na, 5+nc); ``decode_predictions`` turns them into flat
(B, N, 5+nc) detections, flattening each scale in (ny, nx, na) order as the
JAX decode does, so that NMS ties pick the same rows.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.tracing import span
from .quantize import conv_weight


def detect_prior_bias(nc: int, na: int, stride: float,
                      img_size: float = 640.0) -> np.ndarray:
    """Focal-style prior bias (na*(5+nc),): obj ~ 8 objects per 640 px
    image, cls ~ 0.6/(nc-0.99)."""
    b = np.zeros((na, nc + 5), dtype=np.float32)
    b[:, 4] += math.log(8.0 / (img_size / stride) ** 2)
    if nc > 0.99:
        b[:, 5:] += math.log(0.6 / (nc - 0.99))
    return b.reshape(-1)


class Detect(nn.Module):
    """Per-scale 1x1 conv head producing (B, ny, nx, na, 5+nc) raw logits.
    Parameters ``m.{i}.weight/bias`` as in the reference head."""

    def __init__(self, nc: int, anchors: Tuple[Tuple[float, ...], ...],
                 strides: Sequence[int], ch: Sequence[int]):
        super().__init__()
        self.nc = nc
        self.na = len(anchors[0]) // 2
        self.no = nc + 5
        self.strides = tuple(strides)
        self.m = nn.ModuleList(nn.Conv2d(c, self.na * self.no, 1) for c in ch)

    @torch.no_grad()
    def init_prior_bias(self) -> None:
        for conv, s in zip(self.m, self.strides):
            conv.bias.copy_(torch.from_numpy(
                detect_prior_bias(self.nc, self.na, float(s))))

    def forward(self, xs):
        outs = []
        for conv, x in zip(self.m, xs):
            y = F.conv2d(x, conv_weight(conv, x.dtype),
                         conv.bias.to(x.dtype))
            b, _, ny, nx = y.shape
            # channel a*no + o -> (a, o), as the JAX head's reshape
            outs.append(y.permute(0, 2, 3, 1).reshape(b, ny, nx, self.na,
                                                      self.no))
        return tuple(outs)


def anchor_arrays(anchors: Sequence[Sequence[float]]) -> np.ndarray:
    """(nl, na, 2) pixel anchors from the YAML flat form."""
    a = np.asarray(anchors, dtype=np.float32)
    return a.reshape(len(anchors), -1, 2)


def check_anchor_order(anchors_px: np.ndarray,
                       strides: Sequence[int]) -> np.ndarray:
    """Flip the anchor scale order if it disagrees with the stride order."""
    a = anchors_px.reshape(len(strides), -1, 2)
    da = a.prod(-1).mean(-1)[-1] - a.prod(-1).mean(-1)[0]
    ds = strides[-1] - strides[0]
    if np.sign(da) != np.sign(ds):
        a = a[::-1].copy()
    return a


def decode_predictions(feats, anchors_px: np.ndarray, strides: Sequence[int],
                       apply_sigmoid: bool = True) -> torch.Tensor:
    """Raw per-scale head outputs -> flat (B, N, 5+nc) fp32 detections:

        xy = (2*sig(txy) - 0.5 + grid) * stride
        wh = (2*sig(twh))^2 * anchor_px

    obj/cls stay as probabilities. Each scale's anchors go to the device
    by a blocking copy, which waits for the stream: a ``sync.decode_anchors``
    span (utils/tracing)."""
    zs = []
    for i, f in enumerate(feats):
        b, ny, nx, na, no = f.shape
        y = f.float().sigmoid() if apply_sigmoid else f.float()
        gy, gx = torch.meshgrid(
            torch.arange(ny, dtype=torch.float32, device=f.device),
            torch.arange(nx, dtype=torch.float32, device=f.device),
            indexing="ij")
        grid = torch.stack([gx, gy], dim=-1).view(1, ny, nx, 1, 2)
        with span("sync.decode_anchors"):
            anc = torch.as_tensor(np.ascontiguousarray(anchors_px[i]),
                                  dtype=torch.float32,
                                  device=f.device).view(1, 1, 1, na, 2)
        xy = (y[..., 0:2] * 2.0 - 0.5 + grid) * float(strides[i])
        wh = (y[..., 2:4] * 2.0) ** 2 * anc
        z = torch.cat([xy, wh, y[..., 4:]], dim=-1)
        zs.append(z.reshape(b, ny * nx * na, no))
    return torch.cat(zs, dim=1)
