"""Plain fp32 reference of the training recipe's first steps.

Written from YOLOv5's ``ComputeLoss``/``build_targets`` and its training
loop (hyp.scratch: SGD, Nesterov momentum 0.937, weight decay 5e-4 on
kernels, warm-up over 1000 micro-batches from momentum 0.8 and bias lr
0.1, accumulation ramping to a nominal batch of 64, the EMA with decay
0.9999 (1 - exp(-t / 2000))), in the form the JAX package trains and the
port keeps:

- the model in training mode (BatchNorm on the batch's statistics, the
  running statistics moved toward the biased variance), CFT dropout 0.1
  with one mask per (step, stage, layer, slot) drawn by the masks' rule:
  a ``torch.Generator`` on the device seeded with splitmix64 of the step's
  seed, the stage's row and the slot, ``rand < 0.9`` kept and scaled;
- targets assigned to the anchors within a size ratio of 4 and to the
  centre cell and up to two neighbours (g = 0.5), the cells clamped into
  the grid before the regression offsets are taken;
- box loss 1 - CIoU (alpha without a gradient), objectness BCE against
  the detached CIoU clamped at 0, the largest where candidates share a
  cell (YOLOv5 keeps the last write), balanced 4, 1, 0.4 over P3-P5; the
  class loss only for more than one class; the total times the batch;
- parameters in four roles: biases, BatchNorm weights, the position
  embeddings (in no group: never updated) and kernels (the rest, decayed).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

_MASK64 = (1 << 64) - 1
DROPOUT = 0.1
BALANCE = (4.0, 1.0, 0.4)


def mix_seed(*values: int) -> int:
    """splitmix64 finalisers over the values, 63 bits: a mask's key."""
    h = 0x9E3779B97F4A7C15
    for v in values:
        h = ((h ^ (v & _MASK64)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 31)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 29
    return h >> 1


class DropoutKeys:
    """The step's dropout: ``(t, stage row, slot)`` -> t with a mask keyed
    by (step seed, row) and the slot: (0,) the embedded tokens, (layer j,
    s) the attention probabilities (s 0) and the residual branches (1, 2)."""

    def __init__(self, step_seed: int):
        self.seed = step_seed

    def __call__(self, t: torch.Tensor, row: int, slot) -> torch.Tensor:
        stage = mix_seed(self.seed, row)
        key = mix_seed(stage, 0) if len(slot) == 1 else \
            mix_seed(stage, 1 + slot[0] * 3 + slot[1])
        g = torch.Generator(device=t.device)
        g.manual_seed(key)
        keep = torch.rand(t.shape, generator=g, device=t.device) < 1 - DROPOUT
        return torch.where(keep, t / (1 - DROPOUT), torch.zeros_like(t))


def ciou_xywh(b1: torch.Tensor, b2: torch.Tensor, eps: float = 1e-7):
    """CIoU of (K, 4) centre-size boxes, row by row (YOLOv5 bbox_iou)."""
    (x1, y1, w1, h1), (x2, y2, w2, h2) = b1.unbind(-1), b2.unbind(-1)
    a1x, a2x, a1y, a2y = x1 - w1 / 2, x1 + w1 / 2, y1 - h1 / 2, y1 + h1 / 2
    b1x, b2x, b1y, b2y = x2 - w2 / 2, x2 + w2 / 2, y2 - h2 / 2, y2 + h2 / 2
    inter = (torch.min(a2x, b2x) - torch.max(a1x, b1x)).clamp(0) * \
        (torch.min(a2y, b2y) - torch.max(a1y, b1y)).clamp(0)
    w1, h1 = a2x - a1x, a2y - a1y + eps
    w2, h2 = b2x - b1x, b2y - b1y + eps
    iou = inter / (w1 * h1 + w2 * h2 - inter + eps)
    cw = torch.max(a2x, b2x) - torch.min(a1x, b1x)
    ch = torch.max(a2y, b2y) - torch.min(a1y, b1y)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((b1x + b2x - a1x - a2x) ** 2 + (b1y + b2y - a1y - a2y) ** 2) / 4
    v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    with torch.no_grad():
        alpha = v / (v - iou + (1 + eps))
    return iou - (rho2 / c2 + v * alpha)


def build_targets(targets: torch.Tensor, shapes, anchors_grid: torch.Tensor,
                  anchor_t: float = 4.0):
    """targets (n, 6) [image, class, x, y, w, h] normalised (real rows
    only) -> per scale (b, a, gj, gi, txy, twh)."""
    g = 0.5
    off = torch.tensor([[0, 0], [1, 0], [0, 1], [-1, 0], [0, -1]],
                       dtype=torch.float32, device=targets.device) * g
    out = []
    for i, (ny, nx) in enumerate(shapes):
        anc = anchors_grid[i]
        na = len(anc)
        t = targets * torch.tensor([1, 1, nx, ny, nx, ny],
                                   dtype=torch.float32, device=targets.device)
        t = t[None].expand(na, -1, -1)                       # (na, n, 6)
        a = torch.arange(na, device=targets.device)[:, None].expand(
            -1, t.shape[1])
        r = t[..., 4:6] / anc[:, None]
        keep = torch.max(r, 1 / r).max(2)[0] < anchor_t
        t, a = t[keep], a[keep]
        gxy = t[:, 2:4]
        gxi = torch.tensor([nx, ny], device=t.device) - gxy
        j, k = ((gxy % 1 < g) & (gxy > 1)).T
        l, m = ((gxi % 1 < g) & (gxi > 1)).T
        sel = torch.stack([torch.ones_like(j), j, k, l, m])  # (5, n')
        t = t[None].expand(5, -1, -1)[sel]
        a = a[None].expand(5, -1)[sel]
        o = off[:, None].expand(-1, sel.shape[1], -1)[sel]
        gxy = t[:, 2:4]
        gij = torch.floor(gxy - o)
        gi = gij[:, 0].clamp(0, nx - 1)
        gj = gij[:, 1].clamp(0, ny - 1)
        out.append((t[:, 0].long(), a, gj.long(), gi.long(),
                    gxy - torch.stack([gi, gj], 1), t[:, 4:6]))
    return out


@dataclass
class Hyp:
    box: float = 0.05
    obj: float = 1.0
    anchor_t: float = 4.0
    lr0: float = 0.01
    lrf: float = 0.2
    momentum: float = 0.937
    weight_decay: float = 5e-4
    warmup_epochs: float = 3.0
    warmup_momentum: float = 0.8
    warmup_bias_lr: float = 0.1


def yolo_loss(feats, targets: torch.Tensor, anchors_px: torch.Tensor,
              strides, nc: int, hyp: Hyp):
    """(total, box, obj) of raw outputs (B, ny, nx, na, 5 + nc) in fp32."""
    if nc > 1:
        raise NotImplementedError("the reference trains one class")
    dev = feats[0].device
    anchors_grid = anchors_px.to(dev) / torch.tensor(
        strides, dtype=torch.float32, device=dev)[:, None, None]
    B = feats[0].shape[0]
    tg = build_targets(targets, [f.shape[1:3] for f in feats], anchors_grid,
                       hyp.anchor_t)
    lbox = lobj = torch.zeros((), device=dev)
    for i, (f, (b, a, gj, gi, txy, twh)) in enumerate(zip(feats, tg)):
        f = f.float()
        tobj = torch.zeros(f.numel() // f.shape[-1], device=dev)
        if len(b):
            ps = f[b, gj, gi, a]
            pxy = ps[:, 0:2].sigmoid() * 2 - 0.5
            pwh = (ps[:, 2:4].sigmoid() * 2) ** 2 * anchors_grid[i][a]
            ciou = ciou_xywh(torch.cat([pxy, pwh], 1), torch.cat([txy, twh], 1))
            lbox = lbox + (1 - ciou).mean()
            # where candidates share a cell the largest value wins
            cell = ((b * f.shape[1] + gj) * f.shape[2] + gi) * f.shape[3] + a
            tobj = tobj.scatter_reduce(0, cell, ciou.detach().clamp(0),
                                       "amax", include_self=True)
        lobj = lobj + F.binary_cross_entropy_with_logits(
            f[..., 4], tobj.view(f.shape[:4])) * BALANCE[i]
    lbox, lobj = lbox * hyp.box, lobj * hyp.obj
    return (lbox + lobj) * B, lbox, lobj


def roles(model: nn.Module) -> Dict[str, str]:
    """{parameter: role}: ``bias`` (every bias), ``norm`` (BatchNorm
    weights), ``frozen`` (position embeddings), ``kernel`` (the rest)."""
    out = {}
    for mname, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            out[name] = ("frozen" if pname == "pos_emb" else "bias"
                         if pname == "bias" else "norm"
                         if isinstance(mod, nn.BatchNorm2d) else "kernel")
    return out


class Sgd:
    """The recipe's SGD over micro-batches: gradients summed, a step
    emitted when the micro-batch counter is a multiple of the ramped
    accumulation; the warm-up's float32 schedule."""

    def __init__(self, model, hyp: Hyp, steps_per_epoch: int, epochs: int,
                 batch: int):
        self.hyp = hyp
        self.roles = roles(model)
        named = dict(model.named_parameters())
        self.params = {n: named[n] for n in self.roles}
        self.acc = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.buf = {n: torch.zeros_like(p) for n, p in self.params.items()}
        nominal = max(round(64 / batch), 1)
        self.wd = hyp.weight_decay * batch * nominal / 64
        self.nw = max(round(hyp.warmup_epochs * steps_per_epoch), 1000)
        self.ratio = 64.0 / batch
        self.epochs, self.spe = epochs, steps_per_epoch
        self.ni = 0

    def schedule(self, ni: int):
        f32 = np.float32
        h = self.hyp
        e = f32(ni // self.spe)
        lf = ((f32(1) + np.cos(e * f32(math.pi) / f32(self.epochs))) / f32(2)
              ) * f32(1 - h.lrf) + f32(h.lrf)
        base = f32(h.lr0) * lf
        if f32(ni) <= f32(self.nw):
            frac = min(max(f32(ni) * f32(1 / self.nw), f32(0)), f32(1))
            lr = frac * base
            lr_b = f32(h.warmup_bias_lr) + frac * (base - f32(h.warmup_bias_lr))
            mom = f32(h.warmup_momentum) + frac * f32(h.momentum
                                                      - h.warmup_momentum)
            k = max(1.0, float(np.round(f32(float(frac) * float(
                f32(self.ratio - 1)) + 1))))
        else:
            lr = lr_b = base
            mom = f32(h.momentum)
            k = max(1.0, float(np.round(f32(self.ratio))))
        return float(lr), float(lr_b), float(mom), int(k)

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> bool:
        lr, lr_b, mom, k = self.schedule(self.ni)
        emit = self.ni % k == 0
        for n, g in grads.items():
            self.acc[n] += g
        if emit:
            for n, p in self.params.items():
                role = self.roles[n]
                if role == "frozen":
                    continue
                g = self.acc[n] + self.wd * p if role == "kernel" \
                    else self.acc[n]
                self.buf[n].mul_(mom).add_(g)
                p.sub_((lr_b if role == "bias" else lr)
                       * (g + mom * self.buf[n]))
                self.acc[n].zero_()
        self.ni += 1
        return emit


def ema_decay(t: int) -> float:
    f32 = np.float32
    return float(f32(0.9999) * (f32(1) - np.exp(-f32(t) / f32(2000))))


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: nn.Module, t: int):
    """ema = d ema + (1 - d) new, over parameters and floating buffers."""
    d = ema_decay(t)
    for k, v in model.state_dict().items():
        if k in ema:
            ema[k].mul_(d).add_(v.detach(), alpha=1 - d)


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}
