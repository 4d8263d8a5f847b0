"""Plain fp32 reference of the two-stream CFT detector.

Written from the published description (YOLOv5 v5.0 modules; the CFT
paper's GPT fusion stage, arXiv:2111.00273) in plain PyTorch, with
nothing of the program: its own reading of the configuration's rows, its
own modules and decode. Parameter names are the reference torch layout
(``model.{i}.conv.weight``, ``model.{i}.bn.running_mean``,
``model.{i}.trans_blocks.{j}.sa.que_proj.weight``, ...), so the state dict
that the benchmark draws loads here and into the program alike.

BatchNorm stays unfolded: eval mode normalises with the running
statistics in fp32, which is the fold worked out again. Every convolution
and linear layer takes its operands and gives its result through
``rounding``, the identity for the reference itself and a per-tensor fp8
(e4m3) round trip for the control (``fp8_round``): the control stores
what the program stores in bf16 in fp8 instead, and accumulates in fp32. Call ``strict_fp32()`` around a run on the card
so that no matrix product runs in TF32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

Rounding = Optional[Callable[[torch.Tensor], torch.Tensor]]
FP8_MAX = 448.0  # largest finite float8_e4m3fn


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t through float8 e4m3 with one scale per tensor (its largest
    magnitude maps to 448), back in t's dtype: the control's precision."""
    s = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / s).to(torch.float8_e4m3fn).to(t.dtype) * s
    return t + (q - t.detach())  # the gradient passes straight through


@contextlib.contextmanager
def strict_fp32():
    """Matrix products and convolutions in full fp32 (TF32 off) within."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


class Ctx:
    """What every layer of one model shares: the rounding of operands, and
    in training the step's dropout (``train_step.DropoutKeys``)."""

    def __init__(self, rounding: Rounding = None):
        self.r = rounding or (lambda t: t)
        self.dropout = None


class Conv(nn.Module):
    """conv (no bias) -> BatchNorm(eps 1e-3) -> SiLU."""

    def __init__(self, ctx: Ctx, c1, c2, k=1, s=1, p=None, act=True):
        super().__init__()
        self.ctx = ctx
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2 if p is None else p,
                              bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=1e-3, momentum=0.03)
        self.act = act

    def forward(self, x):
        r = self.ctx.r
        y = r(F.conv2d(r(x), r(self.conv.weight), None, self.conv.stride,
                       self.conv.padding))
        bn = self.bn
        if self.training:
            y = batch_norm_train(y, bn)
        else:
            y = F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight,
                             bn.bias, False, 0.0, bn.eps)
        return F.silu(y) if self.act else y


def batch_norm_train(y: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Normalise with the batch's mean and biased variance; the running
    statistics move by ``momentum`` toward the batch's mean and its biased
    variance (the JAX package's flax rule, which the port keeps)."""
    mean = y.mean((0, 2, 3))
    var = ((y - mean[:, None, None]) ** 2).mean((0, 2, 3))
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
        bn.running_var.mul_(1 - m).add_(var.detach(), alpha=m)
    return ((y - mean[:, None, None]) * torch.rsqrt(var + bn.eps)[:, None, None]
            * bn.weight[:, None, None] + bn.bias[:, None, None])


class Focus(nn.Module):
    def __init__(self, ctx, c1, c2, k=1, s=1):
        super().__init__()
        self.conv = Conv(ctx, 4 * c1, c2, k, s)

    def forward(self, x):
        return self.conv(torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2],
                                    x[..., ::2, 1::2], x[..., 1::2, 1::2]], 1))


class Bottleneck(nn.Module):
    def __init__(self, ctx, c1, c2, shortcut=True):
        super().__init__()
        self.cv1 = Conv(ctx, c1, c2, 1)
        self.cv2 = Conv(ctx, c2, c2, 3)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    def __init__(self, ctx, c1, c2, n=1, shortcut=True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(ctx, c1, c_)
        self.cv2 = Conv(ctx, c1, c_)
        self.cv3 = Conv(ctx, 2 * c_, c2)
        self.m = nn.Sequential(*(Bottleneck(ctx, c_, c_, shortcut)
                                 for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class SPP(nn.Module):
    def __init__(self, ctx, c1, c2, k=(5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.k = tuple(k)
        self.cv1 = Conv(ctx, c1, c_)
        self.cv2 = Conv(ctx, c_ * (len(self.k) + 1), c2)

    def forward(self, x):
        x = self.cv1(x)
        return self.cv2(torch.cat(
            [x] + [F.max_pool2d(x, k, 1, k // 2) for k in self.k], 1))


class Upsample(nn.Module):
    def forward(self, x):
        return F.interpolate(x, scale_factor=2, mode="nearest")


class Concat(nn.Module):
    def forward(self, xs):
        return torch.cat(list(xs), 1)


class Add(nn.Module):
    def forward(self, xs):
        return xs[0] + xs[1]


class Add2(nn.Module):
    def __init__(self, index):
        super().__init__()
        self.index = index

    def forward(self, xs):
        return xs[0] + xs[1][self.index]


class SelfAttention(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.que_proj = nn.Linear(c, c)
        self.key_proj = nn.Linear(c, c)
        self.val_proj = nn.Linear(c, c)
        self.out_proj = nn.Linear(c, c)


class TransformerBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.ln_input = nn.LayerNorm(c)
        self.ln_output = nn.LayerNorm(c)
        self.sa = SelfAttention(c)
        self.mlp = nn.Sequential(nn.Linear(c, 4 * c), nn.GELU(),
                                 nn.Linear(4 * c, c))


class GPT(nn.Module):
    """The CFT stage: both maps pooled to 8x8, 128 tokens with a position
    embedding, 8 pre-LN layers of 8-head attention and a 4x GELU MLP, a
    final LayerNorm, the two halves resized back (bilinear). In training,
    dropout 0.1 on the embedded tokens, the attention probabilities and
    both residual branches, masks from ``ctx.dropout``."""

    GRID, HEADS, LAYERS = 8, 8, 8

    def __init__(self, ctx, c):
        super().__init__()
        self.ctx = ctx
        self.index = -1  # the graph row, set by ReferenceModel
        self.pos_emb = nn.Parameter(torch.zeros(1, 2 * self.GRID ** 2, c))
        self.trans_blocks = nn.Sequential(*(TransformerBlock(c)
                                            for _ in range(self.LAYERS)))
        self.ln_f = nn.LayerNorm(c)

    def _lin(self, x, lin):
        r = self.ctx.r
        return r(F.linear(r(x), r(lin.weight), lin.bias))

    def forward(self, xs):
        rgb, ir = xs
        b, c, h, w = rgb.shape
        g, nh = self.GRID, self.HEADS
        drop = self.ctx.dropout if self.training else None

        def maybe(t, slot):
            return t if drop is None else drop(t, self.index, slot)

        tok = torch.cat([F.adaptive_avg_pool2d(rgb, g).flatten(2),
                         F.adaptive_avg_pool2d(ir, g).flatten(2)], 2)
        x = maybe(tok.transpose(1, 2) + self.pos_emb, (0,))
        n, d = x.shape[1], c // nh
        for j, blk in enumerate(self.trans_blocks):
            t = blk.ln_input(x)
            q, k, v = (self._lin(t, p).view(b, n, nh, d).transpose(1, 2)
                       for p in (blk.sa.que_proj, blk.sa.key_proj,
                                 blk.sa.val_proj))
            att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d), -1)
            att = maybe(att, (j, 0))
            o = (att @ v).transpose(1, 2).reshape(b, n, c)
            x = x + maybe(self._lin(o, blk.sa.out_proj), (j, 1))
            t = F.gelu(self._lin(blk.ln_output(x), blk.mlp[0]))
            x = x + maybe(self._lin(t, blk.mlp[2]), (j, 2))
        x = self.ln_f(x)
        half = g * g
        outs = []
        for part in (x[:, :half], x[:, half:]):
            m = part.transpose(1, 2).reshape(b, c, g, g)
            outs.append(F.interpolate(m, size=(h, w), mode="bilinear",
                                      align_corners=False))
        return tuple(outs)


class Detect(nn.Module):
    """Per scale a 1x1 conv with bias to na * (5 + nc) channels, laid out
    (B, ny, nx, na, 5 + nc) with channel a * (5 + nc) + o."""

    def __init__(self, ctx, nc, na, ch):
        super().__init__()
        self.ctx = ctx
        self.na, self.no = na, nc + 5
        self.m = nn.ModuleList(nn.Conv2d(c, na * self.no, 1) for c in ch)

    def forward(self, xs):
        r = self.ctx.r
        out = []
        for conv, x in zip(self.m, xs):
            y = r(F.conv2d(r(x), r(conv.weight), conv.bias))
            b, _, ny, nx = y.shape
            out.append(y.permute(0, 2, 3, 1).reshape(b, ny, nx, self.na,
                                                     self.no))
        return tuple(out)


class ReferenceModel(nn.Module):
    """The configuration's rows (``backbone`` + ``head``, the YOLOv5 row
    grammar ``[from, number, module, args]`` with depth and width gains),
    built from the kinds this detector uses. ``from`` -4 is the IR input."""

    def __init__(self, cfg: dict, rounding: Rounding = None):
        super().__init__()
        self.ctx = Ctx(rounding)
        nc = int(cfg["nc"])
        gd, gw = float(cfg["depth_multiple"]), float(cfg["width_multiple"])
        anchors = [list(map(float, a)) for a in cfg["anchors"]]
        na = len(anchors[0]) // 2
        self.nc = nc
        ch: List[int] = []
        stride: List[int] = []
        mods, self.rows = [], []
        for i, (f, n, kind, args) in enumerate(cfg["backbone"] + cfg["head"]):
            frm = [f] if isinstance(f, int) else list(f)
            frm = [x if x in (-1, -4) or x >= 0 else i + x for x in frm]
            c_in = [3 if x == -4 or not ch else ch[x] for x in frm]
            s_in = [1 if x == -4 or not stride else stride[x] for x in frm]
            n = max(round(n * gd), 1) if n > 1 else n
            c, s = c_in[0], s_in[0]
            ctx = self.ctx
            if kind in ("Focus", "Conv", "C3", "SPP"):
                c = make_divisible(args[0] * gw)
                if kind == "Focus":
                    m, s = Focus(ctx, 3, c, args[1]), s * 2
                elif kind == "Conv":
                    k = args[1] if len(args) > 1 else 1
                    st = args[2] if len(args) > 2 else 1
                    m, s = Conv(ctx, c_in[0], c, k, st), s * st
                elif kind == "C3":
                    m = C3(ctx, c_in[0], c, n,
                           args[1] if len(args) > 1 else True)
                else:
                    m = SPP(ctx, c_in[0], c, args[1])
            elif kind == "nn.Upsample":
                m, s = Upsample(), s // 2
            elif kind == "Concat":
                m, c = Concat(), sum(c_in)
            elif kind == "Add":
                m = Add()
            elif kind == "Add2":
                m = Add2(args[1])
            elif kind == "GPT":
                m = GPT(ctx, c)
                m.index = i
            elif kind == "Detect":
                m = Detect(ctx, nc, na, c_in)
                self.strides = tuple(s_in)
            else:
                raise ValueError(f"row {i}: no reference for {kind!r}")
            mods.append(m)
            self.rows.append((frm, isinstance(f, list)))
            ch.append(c)
            stride.append(s)
        self.model = nn.ModuleList(mods)
        areas = [sum(a[j] * a[j + 1] for j in range(0, len(a), 2))
                 for a in anchors]
        if areas != sorted(areas):
            raise ValueError("anchors must grow with the stride")
        self.anchors = torch.tensor(anchors, device="cpu").view(
            len(anchors), na, 2)

    def forward(self, rgb, ir):
        outs = []
        x = rgb
        for (frm, multi), m in zip(self.rows, self.model):
            if multi:
                inp = [x if j == -1 else outs[j] for j in frm]
            else:
                inp = ir if frm[0] == -4 else x if frm[0] == -1 \
                    else outs[frm[0]]
            x = m(inp)
            outs.append(x)
        return x


def decode(feats, anchors: torch.Tensor, strides) -> torch.Tensor:
    """Raw per-scale outputs -> (B, N, 5 + nc) fp32: xy = (2 sig - 0.5 +
    grid) * stride, wh = (2 sig)^2 * anchor, objectness and classes as
    probabilities; each scale flattened in (ny, nx, na) order."""
    zs = []
    for i, f in enumerate(feats):
        b, ny, nx, na, no = f.shape
        y = f.float().sigmoid()
        gy, gx = torch.meshgrid(torch.arange(ny, dtype=torch.float32,
                                             device=f.device),
                                torch.arange(nx, dtype=torch.float32,
                                             device=f.device), indexing="ij")
        grid = torch.stack([gx, gy], -1).view(1, ny, nx, 1, 2)
        anc = anchors[i].to(f.device).view(1, 1, 1, na, 2)
        xy = (y[..., 0:2] * 2.0 - 0.5 + grid) * float(strides[i])
        wh = (y[..., 2:4] * 2.0) ** 2 * anc
        zs.append(torch.cat([xy, wh, y[..., 4:]], -1).reshape(b, -1, no))
    return torch.cat(zs, 1)
