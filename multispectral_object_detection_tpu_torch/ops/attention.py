"""Pooling and resizing around the CFT token transformer.

Counterpart of the helpers at multispectral_object_detection_tpu/ops/
attention.py:45-100, which reproduce torch's adaptive average pooling and
bilinear resizing (align_corners=False) as static matmuls on the TPU. Here
they are those torch operations, on NCHW maps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def adaptive_avg_pool_2d(x: torch.Tensor, out_hw) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, *out_hw) adaptive average pool."""
    return F.adaptive_avg_pool2d(x, tuple(out_hw))


def bilinear_resize_2d(x: torch.Tensor, out_hw) -> torch.Tensor:
    """(B, C, h, w) -> (B, C, *out_hw) bilinear resize, align_corners=False."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=False)
