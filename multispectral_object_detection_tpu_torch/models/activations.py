"""Alternative activations, the counterparts of multispectral_object_detection_tpu/
models/activations.py (the reference's utils/activations.py): ``silu``,
``hardswish`` and ``mish`` as functions, ``FReLU``, ``AconC`` and
``MetaAconC`` as modules on NCHW maps. No config uses them; SiLU is the
default everywhere.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import bare_batch_norm, conv_cast


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def hardswish(x: torch.Tensor) -> torch.Tensor:
    """x * relu6(x + 3) / 6."""
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x))."""
    return x * torch.tanh(F.softplus(x))


class FReLU(nn.Module):
    """Funnel activation: max(x, BN(depthwise k x k conv(x))), the
    BatchNorm in fp32 (eps 1e-3)."""

    def __init__(self, c1: int, k: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(c1, c1, k, 1, k // 2, groups=c1, bias=False)
        self.bn = nn.BatchNorm2d(c1, eps=1e-3, momentum=0.03)

    def forward(self, x):
        y = bare_batch_norm(conv_cast(x, self.conv), self.bn, self.training)
        return torch.maximum(x, y.to(x.dtype))


def _acon(x, p1, p2, beta):
    dpx = (p1 - p2) * x
    return dpx * torch.sigmoid(beta * dpx) + p2 * x


class AconC(nn.Module):
    """ACON-C: (p1 - p2) x * sigmoid(beta (p1 - p2) x) + p2 x, with
    per-channel p1, p2 ~ N(0, 1) and beta = 1 at initialisation."""

    def __init__(self, c1: int):
        super().__init__()
        self.p1 = nn.Parameter(torch.randn(1, c1, 1, 1))
        self.p2 = nn.Parameter(torch.randn(1, c1, 1, 1))
        self.beta = nn.Parameter(torch.ones(1, c1, 1, 1))

    def forward(self, x):
        return _acon(x, self.p1, self.p2, self.beta)


class MetaAconC(nn.Module):
    """ACON-C whose beta is sigmoid(fc2(fc1(mean over H, W of x))), fc1 to
    max(r, c1 // r) channels; k x k convs with bias."""

    def __init__(self, c1: int, k: int = 1, s: int = 1, r: int = 16):
        super().__init__()
        c2 = max(r, c1 // r)
        self.p1 = nn.Parameter(torch.randn(1, c1, 1, 1))
        self.p2 = nn.Parameter(torch.randn(1, c1, 1, 1))
        self.fc1 = nn.Conv2d(c1, c2, k, s, k // 2, bias=True)
        self.fc2 = nn.Conv2d(c2, c1, k, s, k // 2, bias=True)

    def forward(self, x):
        y = conv_cast(conv_cast(x.mean((2, 3), keepdim=True), self.fc1),
                      self.fc2)
        return _acon(x, self.p1, self.p2, torch.sigmoid(y))
