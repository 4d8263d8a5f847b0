"""Building blocks of the two-stream YOLOv5 graph, NCHW in channels_last.

Counterparts of the modules of multispectral_object_detection_tpu/models/
layers.py: the main path's blocks, then the hub zoo's (BottleneckCSP,
C3TR and its transformer, Ghost blocks, MixConv2d, CrossConv, Contract,
Expand, MaxPool2d, ZeroPad2d, Sum, Classify, dwconv). Parameter names
follow the reference torch modules (``conv``, ``bn``, ``cv1``..``cv4``,
``m.{k}``, ``tr.{k}``, ``ma.in_proj_weight``), so reference state dicts
load as they are.

Numerics as in the JAX modules: convolutions run in the input's dtype
(parameters are cast at use, a no-op once the model is cast), BatchNorm in
fp32 with eps 1e-3, SiLU in the compute dtype. After ``fuse_conv_bn``
(models/model.py) a ConvBnAct holds a conv with bias and no ``bn``; after
``quantize_int8`` (models/quantize.py) its weight is int8 with a scale, read
through ``conv_weight``.

BatchNorm follows the module's mode. In eval mode it reads its running
statistics. In training mode it normalises with the batch's biased variance
and updates ``ra = 0.97 ra + 0.03 batch`` with the biased variance, as flax
``nn.BatchNorm`` does (``F.batch_norm`` would update with the unbiased one).
Inside ``frozen_batch_stats()`` the update is skipped: the forward that
``torch.utils.checkpoint`` recomputes in the backward pass runs there, so a
step updates the statistics once. Under data parallelism (a ConvBnAct's
``mesh`` with more than one data rank, set by parallel/mesh.parallelize)
the statistics
are the global batch's, all-reduced in fp32 forward and backward: the
mean from the summed sums and counts, then the biased variance from the
summed squared deviations (two passes, as one process computes it; flax's
E[x^2] - E[x]^2 rounds differently), and every rank updates its running
statistics alike.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import multi_head_attention
from ..ops.c3_bottleneck import c3_bottleneck
from .parser import autopad
from .quantize import conv_weight


_bn_state = threading.local()


@contextlib.contextmanager
def frozen_batch_stats():
    """BatchNorm in training mode leaves its running statistics unchanged
    within this context (in this thread)."""
    prev = getattr(_bn_state, "frozen", False)
    _bn_state.frozen = True
    try:
        yield
    finally:
        _bn_state.frozen = prev


def batch_norm_train(y: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Normalise y (any float dtype, statistics in fp32) with its batch
    statistics and, unless frozen, update bn's running statistics with the
    biased variance."""
    # F.batch_norm updates copies: autograd keeps the statistics it was
    # given, so the tensors it saw must not change after the call (and a
    # recomputed forward must save the same tensors as the first)
    mean, var = bn.running_mean.clone(), bn.running_var.clone()
    out = F.batch_norm(y, mean, var, bn.weight, bn.bias, True, bn.momentum,
                       bn.eps)
    if not getattr(_bn_state, "frozen", False):
        n = y.numel() // y.shape[1]
        with torch.no_grad():  # the update's variance term times (n-1)/n
            kept = (1.0 - bn.momentum) * bn.running_var
            bn.running_mean.copy_(mean)
            bn.running_var.copy_((var - kept) * ((n - 1) / n) + kept)
    return out


def batch_norm_sync(y: torch.Tensor, bn: nn.BatchNorm2d,
                    group) -> torch.Tensor:
    """``batch_norm_train`` with the statistics of the batch over every rank
    of ``group``, in two passes as ``batch_norm_train`` computes them: the
    per-channel sums and count all-reduced in fp32 give the mean, then
    the all-reduced sum of squared deviations from it the biased variance;
    both all-reduces are differentiated through (their backward
    all-reduces the gradient)."""
    from ..parallel.mesh import all_reduce_autograd

    yf = y.float()
    c = y.shape[1]
    count = yf.new_full((1,), yf.numel() // c)
    s = all_reduce_autograd(torch.cat([yf.sum((0, 2, 3)), count]), group)
    n = s[-1]
    mean = s[:c] / n
    dev = yf - mean[:, None, None]
    var = all_reduce_autograd((dev * dev).sum((0, 2, 3)), group) / n
    out = dev * (torch.rsqrt(var + bn.eps) * bn.weight)[:, None, None] \
        + bn.bias[:, None, None]
    if not getattr(_bn_state, "frozen", False):
        with torch.no_grad():
            m = bn.momentum
            bn.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
            bn.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
    return out.to(y.dtype)


class ConvBnAct(nn.Module):
    """Conv2d(bias=False) + BatchNorm + SiLU: the reference `Conv`."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p=None,
                 g: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p), groups=g,
                              bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=1e-3, momentum=0.03)
        self.act = act
        self.mesh = None  # parallel/mesh.Mesh: SyncBN over its data group

    def forward(self, x):
        c = self.conv
        y = F.conv2d(x, conv_weight(c, x.dtype),
                     None if c.bias is None else c.bias.to(x.dtype),
                     c.stride, c.padding, c.dilation, c.groups)
        if self.bn is not None and self.training:
            mesh = self.mesh
            y = batch_norm_train(y, self.bn) if mesh is None or \
                mesh.n_data == 1 else batch_norm_sync(y, self.bn,
                                                      mesh.data_group)
        elif self.bn is not None:
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
    """1x1 -> 3x3 with an optional residual.

    With ``use_c3_kernel``, a BN-folded bottleneck with a shortcut, g == 1,
    c1 == c2 == c_ and c_ % 64 == 0 (the JAX package's condition for its
    Pallas kernel, models/layers.py) runs as the fused C3 bottleneck kernel
    (ops/c3_bottleneck.py); any other block takes the convolutions. The
    parameters stay ``cv1.conv.*``/``cv2.conv.*``. ``pack`` stores the
    kernel's weight layout once; unpacked (or int8) weights are laid out at
    every call.
    """

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, use_c3_kernel: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, 1, 1)
        self.cv2 = ConvBnAct(c_, c2, 3, 1, g=g)
        self.add = shortcut and c1 == c2
        self.fits_kernel = (use_c3_kernel and shortcut and g == 1
                             and c1 == c2 == c_ and c_ % 64 == 0)
        # the kernel's implementation; a caller may swap in its plain version
        self.c3_fn = c3_bottleneck
        self.register_buffer("w1", None)  # set by `pack`
        self.register_buffer("w2", None)

    @property
    def takes_kernel(self) -> bool:
        """True when this block runs as the fused kernel."""
        return (self.fits_kernel and self.cv1.bn is None
                and self.cv2.bn is None)

    def kernel_weights(self, dtype) -> tuple:
        """w1 (C, C) as (in, out) and w2 (9, C, C) as (tap, in, out)."""
        if self.w1 is not None:
            return self.w1.to(dtype), self.w2.to(dtype)
        w1 = conv_weight(self.cv1.conv, dtype)  # (out, in, 1, 1)
        w2 = conv_weight(self.cv2.conv, dtype)  # (out, in, 3, 3)
        c = w1.shape[0]
        return (w1.reshape(c, c).t().contiguous(),
                w2.permute(2, 3, 1, 0).reshape(9, c, c).contiguous())

    @torch.no_grad()
    def pack(self) -> None:
        """Store the kernel's weight layout as buffers (a fused block that
        takes the kernel; their dtype follows the conv weights')."""
        if self.takes_kernel:
            w1, w2 = self.kernel_weights(self.cv1.conv.weight.dtype)
            self.register_buffer("w1", w1)
            self.register_buffer("w2", w2)

    def unpack(self) -> None:
        self.w1 = self.w2 = None

    def forward(self, x):
        if self.takes_kernel:
            w1, w2 = self.kernel_weights(x.dtype)
            y = self.c3_fn(x.permute(0, 2, 3, 1), w1, self.cv1.conv.bias, w2,
                           self.cv2.conv.bias)
            return y.permute(0, 3, 1, 2)
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convs: the main backbone/neck block."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5, use_c3_kernel: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, 1, 1)
        self.cv2 = ConvBnAct(c1, c_, 1, 1)
        self.cv3 = ConvBnAct(2 * c_, c2, 1)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, e=1.0,
                                            use_c3_kernel=use_c3_kernel)
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


# ---------------------------------------------------------------- hub zoo
# The blocks of the configs off the main path (yolov3, yolov5-fpn/-panet,
# -p2/-p6/-p7, yolov5s-transformer) and the rest of the JAX package's zoo.


def linear_cast(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """``lin`` in x's dtype (its parameters cast at use)."""
    return F.linear(x, lin.weight.to(x.dtype),
                    None if lin.bias is None else lin.bias.to(x.dtype))


def conv_cast(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """A bare ``nn.Conv2d`` in x's dtype (dequantized if int8)."""
    return F.conv2d(x, conv_weight(conv, x.dtype),
                    None if conv.bias is None else conv.bias.to(x.dtype),
                    conv.stride, conv.padding, conv.dilation, conv.groups)


def bare_batch_norm(y: torch.Tensor, bn: nn.BatchNorm2d,
                    training: bool) -> torch.Tensor:
    """A BatchNorm without a conv beside it (BottleneckCSP, MixConv2d,
    FReLU), in fp32: batch statistics in training (``batch_norm_train``,
    not synchronised over data ranks), running statistics otherwise.
    ``fuse_conv_bn`` leaves it live, as the JAX package's fold does."""
    y = y.float()
    if training:
        return batch_norm_train(y, bn)
    return F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, False, 0.0, bn.eps)


def dwconv(c1: int, c2: int, k: int = 1, s: int = 1,
           act: bool = True) -> ConvBnAct:
    """Depthwise-ish conv: a grouped ConvBnAct with g = gcd(c1, c2)."""
    return ConvBnAct(c1, c2, k, s, g=math.gcd(c1, c2), act=act)


class BottleneckCSP(nn.Module):
    """Legacy CSP block: cv1 -> bottlenecks -> bare 1x1 ``cv3``, beside a
    bare 1x1 ``cv2``; the concat through a bare BatchNorm (fp32, live after
    ``fuse_conv_bn``) and LeakyReLU(0.1), then ``cv4``."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, 1, 1)
        self.cv2 = nn.Conv2d(c1, c_, 1, 1, bias=False)
        self.cv3 = nn.Conv2d(c_, c_, 1, 1, bias=False)
        self.cv4 = ConvBnAct(2 * c_, c2, 1, 1)
        self.bn = nn.BatchNorm2d(2 * c_, eps=1e-3, momentum=0.03)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, e=1.0)
                                 for _ in range(n)))

    def forward(self, x):
        y1 = conv_cast(self.m(self.cv1(x)), self.cv3)
        y = torch.cat([y1, conv_cast(x, self.cv2)], 1)
        y = bare_batch_norm(y, self.bn, self.training)
        return self.cv4(F.leaky_relu(y, 0.1).to(x.dtype))


class Contract(nn.Module):
    """Fold space into channels: (B, C, H, W) -> (B, C*g*g, H/g, W/g),
    channel order (row offset, column offset, C)."""

    def __init__(self, gain: int = 2):
        super().__init__()
        self.gain = gain

    def forward(self, x):
        b, c, h, w = x.shape
        s = self.gain
        x = x.reshape(b, c, h // s, s, w // s, s).permute(0, 3, 5, 1, 2, 4)
        return x.reshape(b, c * s * s, h // s, w // s)


class Expand(nn.Module):
    """Unfold channels into space, the inverse of ``Contract``:
    (B, C, H, W) -> (B, C/g^2, H*g, W*g)."""

    def __init__(self, gain: int = 2):
        super().__init__()
        self.gain = gain

    def forward(self, x):
        b, c, h, w = x.shape
        s = self.gain
        x = x.reshape(b, s, s, c // (s * s), h, w).permute(0, 3, 4, 1, 5, 2)
        return x.reshape(b, c // (s * s), h * s, w * s)


class MaxPool2d(nn.Module):
    """Max pool with floor-mode windows and symmetric padding (yolov3-tiny's
    ``nn.MaxPool2d`` rows)."""

    def __init__(self, k: int = 2, s: int = 2, p: int = 0):
        super().__init__()
        self.k, self.s, self.p = k, s, p

    def forward(self, x):
        return F.max_pool2d(x, self.k, self.s, self.p)


class ZeroPad2d(nn.Module):
    """Zero pad by (left, right, top, bottom), torch's argument order."""

    def __init__(self, padding):
        super().__init__()
        self.padding = tuple(padding)

    def forward(self, x):
        return F.pad(x, self.padding)


class GhostConv(nn.Module):
    """Ghost convolution: a ConvBnAct to c2/2 channels and a 5x5 depthwise
    ConvBnAct of it, concatenated."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1,
                 act: bool = True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = ConvBnAct(c1, c_, k, s, None, g, act)
        self.cv2 = ConvBnAct(c_, c_, 5, 1, None, c_, act)

    def forward(self, x):
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], 1)


class GhostBottleneck(nn.Module):
    """Ghost bottleneck with the reference's ``conv.{0,1,2}`` and
    ``shortcut.{0,1}`` names (the JAX package's g1, its first dwconv, g2;
    its second dwconv and sc); the depthwise convs only at stride 2."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        c_ = c2 // 2
        self.conv = nn.Sequential(
            GhostConv(c1, c_, 1, 1),
            dwconv(c_, c_, k, s, act=False) if s == 2 else nn.Identity(),
            GhostConv(c_, c2, 1, 1, act=False))
        self.shortcut = nn.Sequential(
            dwconv(c1, c1, k, s, act=False),
            ConvBnAct(c1, c2, 1, 1, act=False)) if s == 2 else nn.Identity()

    def forward(self, x):
        return self.conv(x) + self.shortcut(x)


class TransformerLayer(nn.Module):
    """Transformer layer without LayerNorm (the C3TR core): ``q``/``k``/``v``
    Linears without bias, then ``nn.MultiheadAttention``'s packed
    in-projection and out-projection around ops/attention.py's attention
    (fp32 logits), a residual, and ``fc2(fc1(x))`` with a residual. ``ma``
    holds the parameters under nn.MultiheadAttention's names; the
    arithmetic is the JAX package's, in x's dtype."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q = nn.Linear(c, c, bias=False)
        self.k = nn.Linear(c, c, bias=False)
        self.v = nn.Linear(c, c, bias=False)
        self.ma = nn.MultiheadAttention(c, num_heads)
        self.fc1 = nn.Linear(c, c, bias=False)
        self.fc2 = nn.Linear(c, c, bias=False)

    def forward(self, x):
        dt = x.dtype
        w, b = self.ma.in_proj_weight.to(dt), self.ma.in_proj_bias.to(dt)
        q, k, v = (F.linear(linear_cast(x, lin), w_i, b_i) for lin, w_i, b_i in
                   zip((self.q, self.k, self.v), w.chunk(3), b.chunk(3)))
        a = multi_head_attention(q, k, v, self.num_heads)
        x = x + linear_cast(a, self.ma.out_proj)
        return x + linear_cast(linear_cast(x, self.fc1), self.fc2)


class TransformerBlock2D(nn.Module):
    """ViT-style block over a map: an optional ConvBnAct to c2, the H*W
    tokens (row-major) plus a learned linear position embedding
    (``linear``), then ``num_layers`` TransformerLayers (``tr.{i}``)."""

    def __init__(self, c1: int, c2: int, num_heads: int, num_layers: int):
        super().__init__()
        self.conv = ConvBnAct(c1, c2, 1, 1) if c1 != c2 else None
        self.linear = nn.Linear(c2, c2)
        self.tr = nn.Sequential(*(TransformerLayer(c2, num_heads)
                                  for _ in range(num_layers)))
        self.c2 = c2

    def forward(self, x):
        if self.conv is not None:
            x = self.conv(x)
        b, c, h, w = x.shape
        p = x.flatten(2).transpose(1, 2)
        y = self.tr(p + linear_cast(p, self.linear))
        return y.transpose(1, 2).reshape(b, c, h, w)


class C3TR(nn.Module):
    """C3 with a TransformerBlock2D (4 heads, n layers) as its core."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, 1, 1)
        self.cv2 = ConvBnAct(c1, c_, 1, 1)
        self.cv3 = ConvBnAct(2 * c_, c2, 1)
        self.m = TransformerBlock2D(c_, c_, 4, n)

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class MixConv2d(nn.Module):
    """Mixed kernel sizes: c2 split equally over the kernels ``k``, bare
    convs ``m.{i}`` concatenated, a bare BatchNorm (fp32, live after
    ``fuse_conv_bn``) and SiLU."""

    def __init__(self, c1: int, c2: int, k: Sequence[int] = (1, 3),
                 s: int = 1):
        super().__init__()
        groups = len(k)
        i = np.floor(np.linspace(0, groups - 1e-6, c2))
        c_ = [int((i == g).sum()) for g in range(groups)]
        self.m = nn.ModuleList(nn.Conv2d(c1, c, kk, s, kk // 2, bias=False)
                               for kk, c in zip(k, c_))
        self.bn = nn.BatchNorm2d(c2, eps=1e-3, momentum=0.03)

    def forward(self, x):
        y = torch.cat([conv_cast(x, m) for m in self.m], 1)
        y = bare_batch_norm(y, self.bn, self.training)
        return F.silu(y).to(x.dtype)


class Sum(nn.Module):
    """Sum of n inputs; with ``weight`` the inputs after the first are
    scaled by 2 * sigmoid(w), w initialised to -(1..n-1)/2."""

    def __init__(self, n: int, weight: bool = False):
        super().__init__()
        self.n = n
        self.weight = weight
        if weight:
            self.w = nn.Parameter(-torch.arange(1.0, n) / 2)

    def forward(self, xs):
        y = xs[0]
        w = torch.sigmoid(self.w.float()) * 2 if self.weight else None
        for i in range(self.n - 1):
            y = y + (xs[i + 1] if w is None else
                     xs[i + 1] * w[i].to(xs[i + 1].dtype))
        return y


class Classify(nn.Module):
    """Classification head: global average pool (of each input, then
    concatenated), a 1x1 conv with bias, flattened to (B, c2)."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, 1, 1, bias=True)

    def forward(self, x):
        if isinstance(x, (list, tuple)):
            z = torch.cat([y.mean((2, 3), keepdim=True) for y in x], 1)
        else:
            z = x.mean((2, 3), keepdim=True)
        return conv_cast(z, self.conv).flatten(1)


class CrossConv(nn.Module):
    """A 1xk then kx1 ConvBnAct pair with an optional residual. The
    reference's names ``cv1``/``cv2`` (the JAX package's ``cv1_conv``,
    ``cv1_bn``, ...); both pairs fold under ``fuse_conv_bn``."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, g: int = 1,
                 e: float = 1.0, shortcut: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, (1, k), (1, s))
        self.cv2 = ConvBnAct(c_, c2, (k, 1), (s, 1), g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y
