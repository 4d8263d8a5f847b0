"""Weights-only int8 quantization for the inference build.

Counterpart of multispectral_object_detection_tpu/models/quantize.py. Every
conv weight becomes an int8 ``weight_q`` plus an fp32 per-output-channel
scale ``weight_s``:

    s[o] = max|W[o]| / 127   (1 where the channel is all zero)
    q[o] = clip(round(W[o] / s[o]), -127, 127)

The JAX package quantizes the leaves named ``kernel`` (conv and head
kernels, output channel on the last axis); here that is each ``nn.Conv2d``
weight, output channel on axis 0 of OIHW. The CFT stacks' packed weights
are not conv weights and stay in the compute dtype, as there. Biases stay
as they are. ``conv_weight`` dequantizes at every forward as q * s with both
cast to the compute dtype first.
"""

from __future__ import annotations

from itertools import chain

import torch
import torch.nn as nn


def conv_weight(conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """A conv's weight in ``dtype``, dequantized if it is int8."""
    q = getattr(conv, "weight_q", None)
    if q is None:
        return conv.weight.to(dtype)
    return q.to(dtype) * conv.weight_s.to(dtype)


@torch.no_grad()
def quantize_int8(model: nn.Module) -> nn.Module:
    """Quantize every conv weight of ``model`` in place; returns it.

    Modules that keep packed copies of conv weights (the fused C3
    bottlenecks, ``unpack``) drop them, so their kernel reads the
    dequantized weights at every call, as in the JAX package."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d) and "weight" in m._parameters:
            w = m.weight.float()
            amax = w.abs().amax(dim=(1, 2, 3), keepdim=True)
            scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
            q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
            del m.weight
            m.register_buffer("weight_q", q)
            m.register_buffer("weight_s", scale)
        elif hasattr(m, "unpack"):
            m.unpack()
    return model


def quantized_bytes(model: nn.Module) -> int:
    """Bytes of all parameters and buffers (for reporting)."""
    return sum(t.numel() * t.element_size()
               for t in chain(model.parameters(), model.buffers()))
