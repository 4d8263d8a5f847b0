"""Plain fp32 reference of Deformable DETR (R50, base variant: no box
refinement, not two-stage), for the benchmark's comparison and the port's
CPU tests.

Written from the published description (Zhu et al., ICLR 2021,
arXiv:2010.04159) and the official repository's PyTorch code
(github.com/fundamentalvision/Deformable-DETR: ``models/backbone.py``,
``models/position_encoding.py``, ``models/deformable_transformer.py``,
``models/deformable_detr.py``, ``models/ops/functions/ms_deform_attn_func.py``)
in plain PyTorch, with nothing of the program. Parameter names are the
official state dict's (``backbone.0.body.layer1.0.conv1.weight``,
``transformer.encoder.layers.0.self_attn.sampling_offsets.weight``,
``class_embed.0.bias``, ...), so a released checkpoint loads here and the
benchmark's draw loads into the program alike.

Inference only, no padding mask: a letterboxed square batch is all valid,
so every valid ratio is 1. Departures from the official code, none of
which changes the arithmetic: the trunk is written out (torchvision's
ResNet-50 layout) rather than imported; the decoder runs its last layer's
heads only (the auxiliary outputs are for training). The multi-scale
deformable attention is ``ms_deform_attn_core_pytorch``, one
``grid_sample`` per level. Every convolution and linear layer takes its
operands and gives its result through ``rounding`` (the identity, or
``model.fp8_round`` for the control), as ``model.ReferenceModel`` does.
Call ``model.strict_fp32()`` around a run on the card.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .model import Ctx, Rounding

MEAN = (0.485, 0.456, 0.406)  # the official transform's ImageNet statistics
STD = (0.229, 0.224, 0.225)


def level_shapes(hw: Tuple[int, int]) -> List[Tuple[int, int]]:
    """(H, W) of the four levels for an input of ``hw``: ResNet-50's
    layer2, layer3 and layer4 (strides 8, 16, 32) and the extra 3x3/2
    convolution on layer4."""
    def down(n, k, s, p):
        return (n + 2 * p - k) // s + 1

    h, w = (down(down(n, 7, 2, 3), 3, 2, 1) for n in hw)  # stem, max pool
    out = []
    for _ in range(4):  # layer2, layer3, layer4 and the extra level
        h, w = down(h, 3, 2, 1), down(w, 3, 2, 1)
        out.append((h, w))
    return out


def ms_deform_attn_core(value: torch.Tensor, shapes: Sequence[Tuple[int, int]],
                        locations: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """The official ``ms_deform_attn_core_pytorch``: value (N, S, M, D),
    locations (N, Q, M, L, P, 2) in [0, 1] (x, y), weights (N, Q, M, L, P)
    -> (N, Q, M * D). Bilinear, align_corners False, zeros outside."""
    n, _, m, d = value.shape
    _, q, _, nl, p, _ = locations.shape
    value_list = value.split([h * w for h, w in shapes], dim=1)
    grids = 2 * locations - 1
    sampled = []
    for lid, (h, w) in enumerate(shapes):
        v = value_list[lid].flatten(2).transpose(1, 2).reshape(n * m, d, h, w)
        g = grids[:, :, :, lid].transpose(1, 2).flatten(0, 1)
        sampled.append(F.grid_sample(v, g, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=False))
    a = weights.transpose(1, 2).reshape(n * m, 1, q, nl * p)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * a).sum(-1)
    return out.view(n, m * d, q).transpose(1, 2).contiguous()


def sine_position(h: int, w: int, feats: int = 128,
                  temperature: float = 10000.0) -> torch.Tensor:
    """``PositionEmbeddingSine(feats, normalize=True)`` of an unmasked
    (h, w) map: (2 * feats, h, w), y's features first."""
    eps, scale = 1e-6, 2 * math.pi
    y = torch.arange(1, h + 1, dtype=torch.float32)[:, None].expand(h, w)
    x = torch.arange(1, w + 1, dtype=torch.float32)[None, :].expand(h, w)
    y = (y - 0.5) / (h + eps) * scale
    x = (x - 0.5) / (w + eps) * scale
    dim_t = torch.arange(feats, dtype=torch.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / feats)
    px, py = x[:, :, None] / dim_t, y[:, :, None] / dim_t
    px = torch.stack((px[:, :, 0::2].sin(), px[:, :, 1::2].cos()),
                     dim=3).flatten(2)
    py = torch.stack((py[:, :, 0::2].sin(), py[:, :, 1::2].cos()),
                     dim=3).flatten(2)
    return torch.cat((py, px), dim=2).permute(2, 0, 1)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(min=0, max=1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


# ------------------------------------------------------------- the trunk
class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with fixed statistics and affine parameters (DETR's)."""

    def __init__(self, n: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        for name, fill in (("weight", 1.0), ("bias", 0.0),
                           ("running_mean", 0.0), ("running_var", 1.0)):
            self.register_buffer(name, torch.full((n,), fill))

    def forward(self, x):
        scale = self.weight * (self.running_var + self.eps).rsqrt()
        bias = self.bias - self.running_mean * scale
        return x * scale[None, :, None, None] + bias[None, :, None, None]


def _conv(ctx: Ctx, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    r = ctx.r
    return r(F.conv2d(r(x), r(conv.weight), conv.bias, conv.stride,
                      conv.padding))


def _lin(ctx: Ctx, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    r = ctx.r
    return r(F.linear(r(x), r(lin.weight), lin.bias))


class Bottleneck(nn.Module):
    """torchvision's ResNet bottleneck (stride on the 3x3 conv)."""

    def __init__(self, ctx: Ctx, c_in: int, width: int, stride: int):
        super().__init__()
        self.ctx = ctx
        self.conv1 = nn.Conv2d(c_in, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = FrozenBatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, 4 * width, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(4 * width)
        self.downsample = None
        if stride != 1 or c_in != 4 * width:
            self.downsample = nn.Sequential(
                nn.Conv2d(c_in, 4 * width, 1, stride, bias=False),
                FrozenBatchNorm2d(4 * width))

    def forward(self, x):
        c = self.ctx
        y = F.relu(self.bn1(_conv(c, self.conv1, x)))
        y = F.relu(self.bn2(_conv(c, self.conv2, y)))
        y = self.bn3(_conv(c, self.conv3, y))
        idt = x if self.downsample is None else self.downsample[1](
            _conv(c, self.downsample[0], x))
        return F.relu(y + idt)


class ResNetBody(nn.Module):
    def __init__(self, ctx: Ctx, blocks: Sequence[int]):
        super().__init__()
        self.ctx = ctx
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        c = 64
        for i, (n, width) in enumerate(zip(blocks, (64, 128, 256, 512))):
            layer = []
            for j in range(n):
                layer.append(Bottleneck(ctx, c, width,
                                        2 if j == 0 and i > 0 else 1))
                c = 4 * width
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))

    def forward(self, x):
        x = F.relu(self.bn1(_conv(self.ctx, self.conv1, x)))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            if i >= 2:
                outs.append(x)
        return outs  # layer2, layer3, layer4


class Backbone(nn.Module):
    def __init__(self, ctx: Ctx, blocks: Sequence[int]):
        super().__init__()
        self.body = ResNetBody(ctx, blocks)


# ------------------------------------------------------ the transformer
class MSDeformAttn(nn.Module):
    def __init__(self, ctx: Ctx, d_model: int, n_levels: int, n_heads: int,
                 n_points: int):
        super().__init__()
        self.ctx = ctx
        self.n_levels, self.n_heads = n_levels, n_heads
        self.n_points = n_points
        self.sampling_offsets = nn.Linear(d_model,
                                          n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model,
                                           n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(self, query, reference, src, shapes):
        """query (N, Q, C); reference (N, Q, L, 2); src (N, S, C)."""
        c = self.ctx
        n, q, _ = query.shape
        m, nl, p = self.n_heads, self.n_levels, self.n_points
        value = _lin(c, self.value_proj, src).view(n, src.shape[1], m, -1)
        off = _lin(c, self.sampling_offsets, query).view(n, q, m, nl, p, 2)
        a = _lin(c, self.attention_weights, query).view(n, q, m, nl * p)
        a = F.softmax(a, -1).view(n, q, m, nl, p)
        norm = torch.tensor([[w, h] for h, w in shapes],
                            dtype=torch.float32, device=query.device)
        loc = reference[:, :, None, :, None, :] \
            + off / norm[None, None, None, :, None, :]
        return _lin(c, self.output_proj,
                    ms_deform_attn_core(value, shapes, loc, a))


class EncoderLayer(nn.Module):
    def __init__(self, ctx, d, ff, levels, heads, points):
        super().__init__()
        self.ctx = ctx
        self.self_attn = MSDeformAttn(ctx, d, levels, heads, points)
        self.norm1 = nn.LayerNorm(d)
        self.linear1 = nn.Linear(d, ff)
        self.linear2 = nn.Linear(ff, d)
        self.norm2 = nn.LayerNorm(d)

    def forward(self, src, pos, reference, shapes):
        c = self.ctx
        src = self.norm1(src + self.self_attn(src + pos, reference, src,
                                              shapes))
        y = _lin(c, self.linear2, F.relu(_lin(c, self.linear1, src)))
        return self.norm2(src + y)


class DecoderLayer(nn.Module):
    def __init__(self, ctx, d, ff, levels, heads, points):
        super().__init__()
        self.ctx = ctx
        self.heads = heads
        self.cross_attn = MSDeformAttn(ctx, d, levels, heads, points)
        self.norm1 = nn.LayerNorm(d)
        self.self_attn = nn.MultiheadAttention(d, heads)
        self.norm2 = nn.LayerNorm(d)
        self.linear1 = nn.Linear(d, ff)
        self.linear2 = nn.Linear(ff, d)
        self.norm3 = nn.LayerNorm(d)

    def _self_attn(self, qk, v):
        """nn.MultiheadAttention(q=k=qk, v) written out, so that its
        products take the rounding too."""
        r, att = self.ctx.r, self.self_attn
        n, q, d = qk.shape
        h = self.heads
        wq, wk, wv = att.in_proj_weight.chunk(3)
        bq, bk, bv = att.in_proj_bias.chunk(3)
        qq, kk, vv = (r(F.linear(r(x), r(w), b)).view(n, q, h, -1)
                      .transpose(1, 2) for x, w, b in
                      ((qk, wq, bq), (qk, wk, bk), (v, wv, bv)))
        s = r(qq @ r(kk.transpose(-1, -2))) / math.sqrt(d // h)
        o = r(r(torch.softmax(s, -1)) @ vv).transpose(1, 2).reshape(n, q, d)
        return _lin(self.ctx, att.out_proj, o)

    def forward(self, tgt, pos, reference, memory, shapes):
        c = self.ctx
        qk = tgt + pos
        tgt = self.norm2(tgt + self._self_attn(qk, tgt))
        tgt = self.norm1(tgt + self.cross_attn(tgt + pos, reference, memory,
                                               shapes))
        y = _lin(c, self.linear2, F.relu(_lin(c, self.linear1, tgt)))
        return self.norm3(tgt + y)


class Stack(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class Transformer(nn.Module):
    def __init__(self, ctx, cfg):
        super().__init__()
        d, ff, nl, h = (cfg["hidden_dim"], cfg["dim_feedforward"],
                        cfg["num_feature_levels"], cfg["nheads"])
        self.level_embed = nn.Parameter(torch.zeros(nl, d))
        self.encoder = Stack([EncoderLayer(ctx, d, ff, nl, h,
                                           cfg["enc_n_points"])
                              for _ in range(cfg["enc_layers"])])
        self.decoder = Stack([DecoderLayer(ctx, d, ff, nl, h,
                                           cfg["dec_n_points"])
                              for _ in range(cfg["dec_layers"])])
        self.reference_points = nn.Linear(d, 2)


class MLP(nn.Module):
    def __init__(self, ctx, d, out, n):
        super().__init__()
        self.ctx = ctx
        dims = [d] * n + [out]
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, lin in enumerate(self.layers):
            x = _lin(self.ctx, lin, x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class DeformableDETR(nn.Module):
    """The whole detector: uint8-scaled images (B, 3, H, W) in [0, 1] ->
    (logits (B, Q, classes), boxes (B, Q, 4) cx, cy, w, h in [0, 1])."""

    def __init__(self, cfg: dict, rounding: Rounding = None):
        super().__init__()
        ctx = self.ctx = Ctx(rounding)
        d, nl = cfg["hidden_dim"], cfg["num_feature_levels"]
        self.cfg = cfg
        self.backbone = nn.ModuleList([Backbone(ctx, cfg["resnet_blocks"])])
        chans = (512, 1024, 2048)
        proj = [nn.Sequential(nn.Conv2d(c, d, 1), nn.GroupNorm(32, d))
                for c in chans]
        c = chans[-1]
        for _ in range(nl - len(chans)):
            proj.append(nn.Sequential(nn.Conv2d(c, d, 3, 2, 1),
                                      nn.GroupNorm(32, d)))
            c = d
        self.input_proj = nn.ModuleList(proj)
        self.transformer = Transformer(ctx, cfg)
        self.query_embed = nn.Embedding(cfg["num_queries"], 2 * d)
        cls = nn.Linear(d, cfg["num_classes"])
        box = MLP(ctx, d, 4, 3)
        # the official heads: one module per decoder layer, shared
        self.class_embed = nn.ModuleList([cls] * cfg["dec_layers"])
        self.bbox_embed = nn.ModuleList([box] * cfg["dec_layers"])

    def forward(self, x):
        c = self.ctx
        mean = torch.tensor(MEAN, device=x.device).view(1, 3, 1, 1)
        std = torch.tensor(STD, device=x.device).view(1, 3, 1, 1)
        feats = self.backbone[0].body((x - mean) / std)
        srcs = []
        for lid, proj in enumerate(self.input_proj):
            src = feats[lid] if lid < len(feats) else (
                feats[-1] if lid == len(feats) else srcs[-1])
            srcs.append(proj[1](_conv(c, proj[0], src)))
        shapes = [tuple(s.shape[-2:]) for s in srcs]
        t = self.transformer
        tokens, pos, refs = [], [], []
        for lid, (src, (h, w)) in enumerate(zip(srcs, shapes)):
            tokens.append(src.flatten(2).transpose(1, 2))
            pe = sine_position(h, w, src.shape[1] // 2).to(x.device)
            pos.append(pe.flatten(1).transpose(0, 1) + t.level_embed[lid])
            ry, rx = torch.meshgrid(
                torch.linspace(0.5, h - 0.5, h, dtype=torch.float32),
                torch.linspace(0.5, w - 0.5, w, dtype=torch.float32),
                indexing="ij")
            refs.append(torch.stack((rx.reshape(-1) / w, ry.reshape(-1) / h),
                                    -1))
        src, pos = torch.cat(tokens, 1), torch.cat(pos, 0)[None]
        n = src.shape[0]
        ref = torch.cat(refs, 0).to(x.device)[None, :, None].expand(
            n, -1, len(shapes), -1)
        for layer in t.encoder.layers:
            src = layer(src, pos, ref, shapes)
        qpos, tgt = self.query_embed.weight.split(src.shape[-1], dim=1)
        qpos, tgt = qpos[None].expand(n, -1, -1), tgt[None].expand(n, -1, -1)
        r = _lin(c, t.reference_points, qpos).sigmoid()
        rin = r[:, :, None].expand(-1, -1, len(shapes), -1)
        for layer in t.decoder.layers:
            tgt = layer(tgt, qpos, rin, src, shapes)
        logits = _lin(c, self.class_embed[-1], tgt)
        box = self.bbox_embed[-1](tgt)
        box = torch.cat([box[..., :2] + inverse_sigmoid(r), box[..., 2:]], -1)
        return logits, box.sigmoid()


def build(cfg: dict, rounding: Rounding = None) -> DeformableDETR:
    return DeformableDETR(cfg, rounding).eval()


def select(logits: torch.Tensor, boxes: torch.Tensor, top_k: int,
           conf: float, canvas: Tuple[int, int]):
    """The official post-process: per image, the ``top_k`` largest of the
    Q x classes sigmoid scores (ties to the lower flat index q * classes +
    class), each with its query's box as xyxy in canvas pixels, kept where
    the score exceeds ``conf``. Returns per image (boxes (k, 4), scores
    (k,), classes (k,)) as numpy, only the kept rows."""
    prob = logits.float().sigmoid().flatten(1).cpu().numpy()
    bx = boxes.float().cpu().numpy().astype(np.float64)
    ncls = logits.shape[-1]
    h, w = canvas
    out = []
    for i in range(len(prob)):
        flat = np.arange(prob.shape[1])
        order = np.lexsort((flat, -prob[i]))[:top_k]
        q, cls, sc = order // ncls, order % ncls, prob[i][order]
        cx, cy, bw, bh = bx[i, q].T
        xyxy = np.stack([(cx - bw / 2) * w, (cy - bh / 2) * h,
                         (cx + bw / 2) * w, (cy + bh / 2) * h], 1)
        keep = sc > conf
        out.append((xyxy[keep], sc[keep], cls[keep]))
    return out
