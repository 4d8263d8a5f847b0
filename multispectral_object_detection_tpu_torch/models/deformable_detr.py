"""Deformable DETR (R50), the port's first set-prediction detector.

Zhu et al., "Deformable DETR: Deformable Transformers for End-to-End
Object Detection" (ICLR 2021, arXiv:2010.04159), the base variant of
github.com/fundamentalvision/Deformable-DETR
(``configs/r50_deformable_detr.sh``: no box refinement, not two-stage), for
inference on unpadded square
batches (every valid ratio 1):

- trunk: torchvision's ResNet-50 layout (stride on the 3x3 conv) written
  with the port's ``ConvBnAct`` (ReLU; frozen BatchNorm, eps 1e-5, which
  ``fuse()`` folds into the convs);
- levels: layer2..4 through a 1x1 conv and GroupNorm(32), and a 3x3/2
  conv on layer4 with GroupNorm(32); each flattened to tokens, with a sine
  position (128 features an axis, normalised) plus a learned level
  embedding;
- encoder: 6 layers of ``x = LN(x + MSDA(x + pos, r, x))``,
  ``x = LN(x + W2 relu(W1 x))``, ``r`` each token's pixel centre;
- decoder: 300 queries (``query_embed`` split into position and target),
  reference points ``sigmoid(Linear(query_pos))``, 6 layers of self
  attention, MSDA into the encoder's memory and a ReLU FFN;
- heads on the last layer: 91 logits and ``sigmoid(MLP(t) + [logit(r),
  0, 0])`` as cx, cy, w, h; ``select`` takes the top 100 of the 300 x 91
  sigmoid scores (no NMS).

Convolutions and linear layers run in the model's dtype; the residual
streams, norms, sampling locations, the attention-weight softmax and the
sampling's accumulation in fp32 (``ops/msda``: kernel K4 on the card).

Parameters carry the port's names; ``load_state_dict`` also takes the
official layout (``backbone.0.body.layer1.0.conv1.weight``,
``input_proj.0.1.weight``, ``class_embed.5.bias``, ...), renamed on load.
Spans: ``model.forward``, ``detr.backbone``, ``detr.encoder``,
``detr.decoder``, ``msda`` (ops/msda, 12 a forward; on the card each holds
one ``k4.msda``), ``detr.select``.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.msda import ms_deform_attn
from ..ops.nms import Detections
from ..utils.tracing import span
from . import layers as L

MEAN = (0.485, 0.456, 0.406)  # ImageNet statistics of the official transform
STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class DetrSpec:
    """What callers read of a model besides its forward (``hub.Detector``
    reads ``nc`` and ``two_stream``)."""

    nc: int
    top_k: int
    two_stream: bool = False


def lin(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A linear layer in its weight's dtype."""
    return F.linear(x.to(m.weight.dtype), m.weight, m.bias)


def norm(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm or GroupNorm in fp32 (their parameters stay fp32)."""
    if isinstance(m, nn.GroupNorm):
        return F.group_norm(x.float(), m.num_groups, m.weight.float(),
                            m.bias.float(), m.eps)
    return F.layer_norm(x.float(), m.normalized_shape, m.weight.float(),
                        m.bias.float(), m.eps)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(min=0, max=1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def sine_position(h: int, w: int, feats: int,
                  temperature: float = 10000.0) -> torch.Tensor:
    """DETR's normalised sine embedding of an unmasked (h, w) map as
    tokens: (h * w, 2 * feats), y's features first, fp32."""
    eps, scale = 1e-6, 2 * math.pi
    ys, xs = ((torch.arange(1, n + 1, dtype=torch.float32) - 0.5)
              / (n + eps) * scale for n in (h, w))
    dim_t = temperature ** (2 * (torch.arange(feats, dtype=torch.float32)
                                 // 2) / feats)

    def embed(t):  # (n,) -> (n, feats): sin, cos interleaved
        a = t[:, None] / dim_t
        return torch.stack((a[:, 0::2].sin(), a[:, 1::2].cos()), 2).flatten(1)

    py, px = embed(ys), embed(xs)
    return torch.cat((py[:, None].expand(h, w, feats),
                      px[None].expand(h, w, feats)), 2).reshape(h * w, -1)


# ------------------------------------------------------------- the trunk
class ConvBnRelu(L.ConvBnAct):
    """conv (no bias) + frozen BatchNorm (eps 1e-5) + optional ReLU: the
    port's ConvBnAct, which ``fuse_conv_bn`` folds, with torchvision's
    activation in place of SiLU."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 relu: bool = True):
        super().__init__(c1, c2, k, s, act=False)
        self.bn.eps = 1e-5
        self.relu = relu

    def forward(self, x):
        y = super().forward(x)
        return F.relu(y) if self.relu else y


class Bottleneck(nn.Module):
    def __init__(self, c_in: int, width: int, stride: int):
        super().__init__()
        self.cv1 = ConvBnRelu(c_in, width, 1)
        self.cv2 = ConvBnRelu(width, width, 3, stride)
        self.cv3 = ConvBnRelu(width, 4 * width, 1, relu=False)
        self.down = None
        if stride != 1 or c_in != 4 * width:
            self.down = ConvBnRelu(c_in, 4 * width, 1, stride, relu=False)

    def forward(self, x):
        y = self.cv3(self.cv2(self.cv1(x)))
        return F.relu(y + (x if self.down is None else self.down(x)))


class ResNet(nn.Module):
    """ResNet-50's stem and four stages; returns layer2..4."""

    def __init__(self, blocks: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.stem = ConvBnRelu(3, 64, 7, 2)
        c = 64
        for i, (n, width) in enumerate(zip(blocks, (64, 128, 256, 512))):
            stage = []
            for j in range(n):
                stage.append(Bottleneck(c, width, 2 if j == 0 and i else 1))
                c = 4 * width
            setattr(self, f"layer{i + 1}", nn.Sequential(*stage))

    def forward(self, x):
        x = F.max_pool2d(self.stem(x), 3, 2, 1)
        x = self.layer1(x)
        outs = [self.layer2(x)]
        outs.append(self.layer3(outs[-1]))
        outs.append(self.layer4(outs[-1]))
        return outs


class LevelProj(nn.Module):
    def __init__(self, c_in: int, d: int, k: int, s: int):
        super().__init__()
        self.conv = nn.Conv2d(c_in, d, k, s, k // 2)
        self.norm = nn.GroupNorm(32, d)

    def forward(self, x):
        c = self.conv
        return norm(self.norm, F.conv2d(x, c.weight.to(x.dtype),
                                        c.bias.to(x.dtype), c.stride,
                                        c.padding))


# ------------------------------------------------------ the transformer
class MSDeformAttn(nn.Module):
    def __init__(self, d: int, levels: int, heads: int, points: int):
        super().__init__()
        self.heads, self.points = heads, points
        self.sampling_offsets = nn.Linear(d, heads * levels * points * 2)
        self.attention_weights = nn.Linear(d, heads * levels * points)
        self.value_proj = nn.Linear(d, d)
        self.output_proj = nn.Linear(d, d)

    def forward(self, query, reference, src, shapes):
        n, s, _ = src.shape
        value = lin(self.value_proj, src).view(n, s, self.heads, -1)
        out = ms_deform_attn(value, shapes, reference,
                             lin(self.sampling_offsets, query),
                             lin(self.attention_weights, query), self.points)
        return lin(self.output_proj, out)


class EncoderLayer(nn.Module):
    def __init__(self, d, ff, levels, heads, points):
        super().__init__()
        self.self_attn = MSDeformAttn(d, levels, heads, points)
        self.norm1 = nn.LayerNorm(d)
        self.linear1 = nn.Linear(d, ff)
        self.linear2 = nn.Linear(ff, d)
        self.norm2 = nn.LayerNorm(d)

    def forward(self, x, pos, reference, shapes):
        x = norm(self.norm1, x + self.self_attn(x + pos, reference, x, shapes))
        return norm(self.norm2, x + lin(self.linear2,
                                        F.relu(lin(self.linear1, x))))


class SelfAttention(nn.Module):
    """nn.MultiheadAttention's parameters (q = k from one input, v from
    another), computed by SDPA in the weights' dtype."""

    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = nn.Linear(d, d)

    def forward(self, qk, v):
        n, q, d = qk.shape
        w, b = self.in_proj_weight, self.in_proj_bias
        qq, kk = F.linear(qk.to(w.dtype), w[:2 * d], b[:2 * d]).chunk(2, -1)
        vv = F.linear(v.to(w.dtype), w[2 * d:], b[2 * d:])
        qq, kk, vv = (t.view(n, q, self.heads, -1).transpose(1, 2)
                      for t in (qq, kk, vv))
        o = F.scaled_dot_product_attention(qq, kk, vv)
        return lin(self.out_proj, o.transpose(1, 2).reshape(n, q, d))


class DecoderLayer(nn.Module):
    def __init__(self, d, ff, levels, heads, points):
        super().__init__()
        self.cross_attn = MSDeformAttn(d, levels, heads, points)
        self.norm1 = nn.LayerNorm(d)
        self.self_attn = SelfAttention(d, heads)
        self.norm2 = nn.LayerNorm(d)
        self.linear1 = nn.Linear(d, ff)
        self.linear2 = nn.Linear(ff, d)
        self.norm3 = nn.LayerNorm(d)

    def forward(self, t, pos, reference, memory, shapes):
        t = norm(self.norm2, t + self.self_attn(t + pos, t))
        t = norm(self.norm1, t + self.cross_attn(t + pos, reference, memory,
                                                 shapes))
        return norm(self.norm3, t + lin(self.linear2,
                                        F.relu(lin(self.linear1, t))))


class Stack(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class Transformer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d, ff, nl, h = (cfg["hidden_dim"], cfg["dim_feedforward"],
                        cfg["num_feature_levels"], cfg["nheads"])
        self.level_embed = nn.Parameter(torch.zeros(nl, d))
        self.encoder = Stack([EncoderLayer(d, ff, nl, h, cfg["enc_n_points"])
                              for _ in range(cfg["enc_layers"])])
        self.decoder = Stack([DecoderLayer(d, ff, nl, h, cfg["dec_n_points"])
                              for _ in range(cfg["dec_layers"])])
        self.reference_points = nn.Linear(d, 2)


class MLP(nn.Module):
    def __init__(self, d: int, out: int, n: int):
        super().__init__()
        dims = [d] * n + [out]
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, m in enumerate(self.layers):
            x = lin(m, x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


# the official state dict's names -> the port's (class_embed and bbox_embed
# hold one module per decoder layer there, the same one in this variant)
_OFFICIAL = [
    (r"backbone\.0\.body\.conv1\.weight", r"trunk.stem.conv.weight"),
    (r"backbone\.0\.body\.bn1\.", r"trunk.stem.bn."),
    (r"backbone\.0\.body\.(layer\d)\.(\d+)\.conv(\d)\.",
     r"trunk.\1.\2.cv\3.conv."),
    (r"backbone\.0\.body\.(layer\d)\.(\d+)\.bn(\d)\.",
     r"trunk.\1.\2.cv\3.bn."),
    (r"backbone\.0\.body\.(layer\d)\.(\d+)\.downsample\.0\.",
     r"trunk.\1.\2.down.conv."),
    (r"backbone\.0\.body\.(layer\d)\.(\d+)\.downsample\.1\.",
     r"trunk.\1.\2.down.bn."),
    (r"input_proj\.(\d+)\.0\.", r"input_proj.\1.conv."),
    (r"input_proj\.(\d+)\.1\.", r"input_proj.\1.norm."),
]


class DeformableDETR(nn.Module):
    """Images (B, 3, H, W) in [0, 1] -> (logits (B, Q, nc) fp32, boxes
    (B, Q, 4) cx, cy, w, h in [0, 1], fp32)."""

    def __init__(self, cfg: dict, nc=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        d, nl = cfg["hidden_dim"], cfg["num_feature_levels"]
        nc = cfg["num_classes"] if nc is None else nc
        self.spec = DetrSpec(nc=nc, top_k=cfg["top_k"])
        self.dtype = dtype
        self.trunk = ResNet(cfg["resnet_blocks"])
        chans = (512, 1024, 2048)
        self.input_proj = nn.ModuleList(
            [LevelProj(c, d, 1, 1) for c in chans]
            + [LevelProj(chans[-1] if i == 0 else d, d, 3, 2)
               for i in range(nl - len(chans))])
        self.transformer = Transformer(cfg)
        self.query_embed = nn.Embedding(cfg["num_queries"], 2 * d)
        self.class_embed = nn.Linear(d, nc)
        self.bbox_embed = MLP(d, 4, 3)
        # "norm" in their names keeps them fp32 (cast_inference_params)
        self.register_buffer("pixel_norm_mean", torch.tensor(MEAN).view(
            1, 3, 1, 1), persistent=False)
        self.register_buffer("pixel_norm_std", torch.tensor(STD).view(
            1, 3, 1, 1), persistent=False)
        self._grids: Dict[tuple, tuple] = {}
        self._last = str(cfg["dec_layers"] - 1)
        self.register_load_state_dict_pre_hook(_from_official)

    def _token_grid(self, shapes: List[Tuple[int, int]], device):
        """(sine positions (S, C), each token's level (S,), its pixel
        centre (1, S, 2)) for these level shapes, made once per shapes."""
        key = (tuple(shapes), str(device))
        if key not in self._grids:
            d = self.transformer.level_embed.shape[1]
            pos, lvl, ref = [], [], []
            for i, (h, w) in enumerate(shapes):
                pos.append(sine_position(h, w, d // 2))
                lvl.append(torch.full((h * w,), i))
                ry, rx = torch.meshgrid((torch.arange(h) + 0.5) / h,
                                        (torch.arange(w) + 0.5) / w,
                                        indexing="ij")
                ref.append(torch.stack((rx.reshape(-1), ry.reshape(-1)), -1))
            self._grids[key] = (torch.cat(pos).to(device),
                                torch.cat(lvl).to(device),
                                torch.cat(ref)[None].to(device))
        return self._grids[key]

    def forward(self, x):
        with span("model.forward"):
            with span("detr.backbone"):
                x = ((x.float() - self.pixel_norm_mean) / self.pixel_norm_std
                     ).to(self.dtype)
                feats = self.trunk(x)
                srcs = []
                for i, proj in enumerate(self.input_proj):
                    # the first extra level reads layer4, later ones the last
                    src = feats[min(i, len(feats) - 1)] if i <= len(feats) \
                        else srcs[-1]
                    srcs.append(proj(src.to(self.dtype)))
            shapes = [tuple(s.shape[-2:]) for s in srcs]
            t = self.transformer
            with span("detr.encoder"):
                sine, lvl, ref = self._token_grid(shapes, x.device)
                pos = (sine + t.level_embed.float()[lvl])[None]
                mem = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs],
                                1)
                for layer in t.encoder.layers:
                    mem = layer(mem, pos, ref, shapes)
            with span("detr.decoder"):
                n, d = mem.shape[0], mem.shape[-1]
                qpos, tgt = self.query_embed.weight.float().split(d, 1)
                qpos, tgt = qpos[None].expand(n, -1, -1), tgt[None].expand(
                    n, -1, -1)
                r = lin(t.reference_points, qpos).float().sigmoid()
                for layer in t.decoder.layers:
                    tgt = layer(tgt, qpos, r, mem, shapes)
                logits = lin(self.class_embed, tgt).float()
                box = self.bbox_embed(tgt).float()
                box = torch.cat([box[..., :2] + inverse_sigmoid(r),
                                 box[..., 2:]], -1).sigmoid()
            return logits, box

    def select(self, raw, conf: float, canvas: Tuple[int, int]) -> Detections:
        """The top ``spec.top_k`` of each image's Q x nc sigmoid scores
        (ties to the lower flat index q * nc + class), with their queries'
        boxes as xyxy in canvas pixels; ``valid`` where score > conf."""
        with span("detr.select"):
            logits, boxes = raw
            nc = logits.shape[-1]
            prob = logits.float().sigmoid().flatten(1)
            scores, idx = prob.sort(dim=1, descending=True, stable=True)
            scores, idx = scores[:, :self.spec.top_k], idx[:, :self.spec.top_k]
            q = torch.div(idx, nc, rounding_mode="floor")
            b = boxes.float().gather(1, q[..., None].expand(-1, -1, 4))
            cx, cy, w, h = b.unbind(-1)
            sh, sw = canvas
            xyxy = torch.stack([(cx - w / 2) * sw, (cy - h / 2) * sh,
                                (cx + w / 2) * sw, (cy + h / 2) * sh], -1)
            return Detections(xyxy, scores, (idx - q * nc).to(torch.int32),
                              scores > conf)

    def fuse(self) -> "DeformableDETR":
        """Inference form: every frozen BatchNorm folded into its conv."""
        from .model import fuse_conv_bn

        return fuse_conv_bn(self)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "DeformableDETR":
        """The official initialisation, drawn from ``generator``: convs
        normal(0, 1/fan_in) with frozen BatchNorm at identity, linears
        xavier-uniform with zero bias, sampling offsets zero with the
        grid bias (head h along its direction, point p at p + 1 pixels),
        attention weights zero, level and query embeddings normal(0, 1),
        the class bias at prior 0.01, the box head's last layer zero
        with bias -2 on w and h."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                                 generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm, nn.GroupNorm)):
                m.reset_parameters()
            elif isinstance(m, (nn.Linear, SelfAttention)):
                w, b = (m.weight, m.bias) if isinstance(m, nn.Linear) else (
                    m.in_proj_weight, m.in_proj_bias)
                bound = math.sqrt(6.0 / sum(w.shape))
                w.uniform_(-bound, bound, generator=generator)
                b.zero_()
        for m in self.modules():
            if isinstance(m, MSDeformAttn):
                heads = m.heads
                levels = m.attention_weights.out_features // heads // m.points
                theta = torch.arange(heads) * (2 * math.pi / heads)
                g = torch.stack([theta.cos(), theta.sin()], -1)
                g = (g / g.abs().max(-1, keepdim=True)[0]).view(heads, 1, 1, 2)
                g = g.repeat(1, levels, m.points, 1) * torch.arange(
                    1, m.points + 1).view(1, 1, -1, 1)
                m.sampling_offsets.weight.zero_()
                m.sampling_offsets.bias.copy_(g.flatten())
                m.attention_weights.weight.zero_()
                m.attention_weights.bias.zero_()
        self.transformer.level_embed.normal_(generator=generator)
        self.query_embed.weight.normal_(generator=generator)
        self.class_embed.bias.fill_(-math.log((1 - 0.01) / 0.01))
        last = self.bbox_embed.layers[-1]
        last.weight.zero_()
        last.bias.copy_(torch.tensor([0.0, 0.0, -2.0, -2.0]))
        return self


def _from_official(module: DeformableDETR, sd, prefix, *_):
    """Rename the official layout's keys to the port's, in place; of the
    per-layer copies of the heads, the last layer's is kept."""
    heads = re.compile(re.escape(prefix)
                       + r"(class_embed|bbox_embed)\.(\d+)\.")
    for key in list(sd):
        new = key
        m = heads.match(key)
        if m:
            if m.group(2) != module._last:
                del sd[key]
                continue
            new = prefix + m.group(1) + "." + key[m.end():]
        elif key.startswith(prefix):
            rest = key[len(prefix):]
            for pat, rep in _OFFICIAL:
                rest, k = re.subn("^" + pat, rep, rest)
                if k:
                    break
            new = prefix + rest
        if new != key:
            sd[new] = sd.pop(key)
