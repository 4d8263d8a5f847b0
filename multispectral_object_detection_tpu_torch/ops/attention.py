"""Attention, pooling and resizing around the transformer blocks.

Counterpart of multispectral_object_detection_tpu/ops/attention.py:
``multi_head_attention`` is its plain scaled dot-product attention (the
C3TR blocks' attention; the CFT stages run ops/cft_stack.py instead), and
the pooling and resizing helpers reproduce torch's adaptive average
pooling and bilinear resizing (align_corners=False), which the JAX module
builds as static matmuls on the TPU; here they are those torch
operations, on NCHW maps.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int) -> torch.Tensor:
    """softmax(QK^T / sqrt(d)) V over projected (B, N, C) tensors, d =
    C / num_heads: logits, softmax and the weighted sum accumulate in fp32,
    the probabilities and the output are rounded to q's dtype."""
    b, n, c = q.shape
    d = c // num_heads
    dt = q.dtype

    def heads(t):
        return t.reshape(b, n, num_heads, d).transpose(1, 2).float()

    logits = heads(q) @ heads(k).transpose(-1, -2) / math.sqrt(d)
    attn = torch.softmax(logits, dim=-1).to(dt)
    out = (attn.float() @ heads(v)).to(dt)
    return out.transpose(1, 2).reshape(b, n, c)


def adaptive_avg_pool_2d(x: torch.Tensor, out_hw) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, *out_hw) adaptive average pool."""
    return F.adaptive_avg_pool2d(x, tuple(out_hw))


def bilinear_resize_2d(x: torch.Tensor, out_hw) -> torch.Tensor:
    """(B, C, h, w) -> (B, C, *out_hw) bilinear resize, align_corners=False."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=False)
