"""Building blocks of the two-stream YOLOv5 graph, NCHW in channels_last.

Counterparts of the modules of multispectral_object_detection_tpu/models/
layers.py that the main path runs. Parameter names follow the reference
torch modules (``conv``, ``bn``, ``cv1``..``cv3``, ``m.{k}``), so reference
state dicts load as they are.

Numerics as in the JAX modules: convolutions run in the input's dtype
(parameters are cast at use, a no-op once the model is cast), BatchNorm in
fp32 with eps 1e-3, SiLU in the compute dtype. After ``fuse_conv_bn``
(models/model.py) a ConvBnAct holds a conv with bias and no ``bn``.
Inference only: BatchNorm always uses its running statistics.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .parser import autopad


class ConvBnAct(nn.Module):
    """Conv2d(bias=False) + BatchNorm + SiLU: the reference `Conv`."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p=None,
                 g: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p), groups=g,
                              bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=1e-3, momentum=0.03)
        self.act = act

    def forward(self, x):
        c = self.conv
        y = F.conv2d(x, c.weight.to(x.dtype),
                     None if c.bias is None else c.bias.to(x.dtype),
                     c.stride, c.padding, c.dilation, c.groups)
        if self.bn is not None:
            bn = self.bn
            y = F.batch_norm(y.float(), bn.running_mean, bn.running_var,
                             bn.weight, bn.bias, False, 0.0,
                             bn.eps).to(x.dtype)
        return F.silu(y) if self.act else y


class Focus(nn.Module):
    """Space-to-depth 2x (4-way pixel deinterleave concat) + Conv; the conv
    weight keeps the reference (c2, 4*c1, k, k) layout."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p=None,
                 g: int = 1, act: bool = True):
        super().__init__()
        self.conv = ConvBnAct(c1 * 4, c2, k, s, p, g, act)

    def forward(self, x):
        return self.conv(torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2],
                                    x[..., ::2, 1::2], x[..., 1::2, 1::2]], 1))


class Bottleneck(nn.Module):
    """1x1 -> 3x3 with an optional residual."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, 1, 1)
        self.cv2 = ConvBnAct(c_, c2, 3, 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convs: the main backbone/neck block."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, 1, 1)
        self.cv2 = ConvBnAct(c1, c_, 1, 1)
        self.cv3 = ConvBnAct(2 * c_, c2, 1)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, e=1.0)
                                 for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class SPP(nn.Module):
    """Spatial pyramid pooling: stride-1 'same' max pools at k=(5, 9, 13).
    One k x k pool equals the JAX package's iterated 3x3 pools forward."""

    def __init__(self, c1: int, c2: int, k: Sequence[int] = (5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.k = tuple(k)
        self.cv1 = ConvBnAct(c1, c_, 1, 1)
        self.cv2 = ConvBnAct(c_ * (len(self.k) + 1), c2, 1, 1)

    def forward(self, x):
        x = self.cv1(x)
        return self.cv2(torch.cat(
            [x] + [F.max_pool2d(x, k, 1, k // 2) for k in self.k], 1))


class Upsample(nn.Module):
    """Nearest-neighbour upsample by an integer factor."""

    def __init__(self, scale: int = 2, mode: str = "nearest"):
        super().__init__()
        if mode != "nearest":
            raise NotImplementedError(mode)
        self.scale = scale

    def forward(self, x):
        return F.interpolate(x, scale_factor=self.scale, mode="nearest")


class Concat(nn.Module):
    """Channel concat of a list of maps."""

    def forward(self, xs):
        return torch.cat(list(xs), 1)


class Add(nn.Module):
    """Elementwise add of two stream features."""

    def forward(self, xs):
        return xs[0] + xs[1]


class Add2(nn.Module):
    """Residual add of a stream map and one element of the CFT output pair:
    index 0 = RGB branch, 1 = IR branch."""

    def __init__(self, index: int):
        super().__init__()
        self.index = index

    def forward(self, xs):
        return xs[0] + xs[1][self.index]
