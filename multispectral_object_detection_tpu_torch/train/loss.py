"""Detection training objective: CIoU box + objectness BCE + class BCE.

Counterpart of multispectral_object_detection_tpu/train/loss.py, on the raw
head outputs in fp32, over the fixed-shape candidates of train/assigner.py:

- box: mean(1 - CIoU) over the valid candidates of each scale, summed;
- obj: BCE over every cell; positives carry the detached CIoU clamped at 0
  (gr = 1) as target, a scatter-max over candidates that share a cell (the
  reference keeps the last write), balanced (4, 1, 0.4) over P3-P5;
- cls: BCE with optional label smoothing, only when nc > 1;
- total = (box*gain + obj*gain + cls*gain) * batch * loss_mult
  (``loss_mult`` 4 under ``--quad``, whose canvas batch is 4x smaller).

On a data-parallel mesh (``mesh`` with more than one data rank) the means'
denominators (valid candidates per scale, cells) are the global batch's,
all-reduced before the division, and the batch is the global one: the
ranks' losses then sum to the loss of the global batch (parallel/mesh.py).

``fl_gamma > 0`` scales the BCE terms by the focal (or, with ``qfl``, the
quality focal) factor. Nothing here reads a value back to the host, and
the constants (anchors, cell offsets) are copied to a device once.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.boxes import iou as box_iou_elementwise
from .assigner import OFFSETS, assign_targets


@dataclasses.dataclass(frozen=True)
class LossHyp:
    """The loss keys of hyp.scratch.yaml."""

    box: float = 0.05
    obj: float = 1.0
    cls: float = 0.5
    cls_pw: float = 1.0
    obj_pw: float = 1.0
    anchor_t: float = 4.0
    fl_gamma: float = 0.0
    qfl: bool = False  # quality focal instead of focal
    label_smoothing: float = 0.0
    gr: float = 1.0    # iou ratio of the objectness targets


def scale_gains(hyp: LossHyp, nc: int, img_size: int, nl: int) -> LossHyp:
    """Rescale the gains to the model and task, as the reference trainer
    does once: box *= 3/nl, cls *= nc/80 * 3/nl,
    obj *= (img_size/640)^2 * 3/nl."""
    return dataclasses.replace(
        hyp,
        box=hyp.box * 3.0 / nl,
        cls=hyp.cls * nc / 80.0 * 3.0 / nl,
        obj=hyp.obj * (img_size / 640.0) ** 2 * 3.0 / nl)


def _bce_logits(logits, targets, pos_weight: float = 1.0):
    """-[pw * t * log sigmoid(x) + (1 - t) * log sigmoid(-x)], elementwise."""
    return -(pos_weight * targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))


def bce_blur_with_logits(logits, targets, alpha: float = 0.05):
    """BCE scaled down where the prediction overshoots the target (fewer
    penalties for missing labels); the mean."""
    loss = _bce_logits(logits, targets)
    dx = torch.sigmoid(logits) - targets
    alpha_factor = 1.0 - torch.exp((dx - 1.0) / (alpha + 1e-4))
    return (loss * alpha_factor).mean()


def focal_scale(logits, targets, gamma: float, alpha: float = 0.25):
    """The focal modulation alpha_t * (1 - p_t)^gamma."""
    p = torch.sigmoid(logits)
    p_t = targets * p + (1.0 - targets) * (1.0 - p)
    alpha_factor = targets * alpha + (1.0 - targets) * (1.0 - alpha)
    return alpha_factor * (1.0 - p_t) ** gamma


def qfocal_scale(logits, targets, gamma: float, alpha: float = 0.25):
    """The quality focal modulation alpha_t * |t - p|^gamma."""
    p = torch.sigmoid(logits)
    alpha_factor = targets * alpha + (1.0 - targets) * (1.0 - alpha)
    return alpha_factor * (targets - p).abs() ** gamma


def _masked_mean(x, mask):
    return (x * mask).sum() / mask.sum().clamp(min=1.0)


class DetectionLoss:
    """(feats, targets, tmask) -> (total, {"box", "obj", "cls", "total"}),
    every value a 0-d fp32 tensor on the feats' device.

    feats: per-scale raw logits (B, ny, nx, na, 5+nc); targets (T, 6)
    padded [img, cls, x, y, w, h] normalised; tmask (T,)."""

    BALANCE3 = (4.0, 1.0, 0.4)          # P3-P5
    BALANCE5 = (4.0, 1.0, 0.25, 0.06, 0.02)

    def __init__(self, nc: int, anchors_px: np.ndarray,
                 strides: Sequence[int], hyp: LossHyp = LossHyp(),
                 loss_mult: float = 1.0, mesh=None):
        self.nc = nc
        self.loss_mult = loss_mult
        self.mesh = mesh
        self.strides = tuple(strides)
        self.anchors_grid = np.asarray(anchors_px, np.float32) / np.asarray(
            strides, np.float32).reshape(-1, 1, 1)
        self.hyp = hyp
        self.balance = self.BALANCE3 if len(strides) == 3 else self.BALANCE5
        eps = hyp.label_smoothing
        self.cp, self.cn = 1.0 - 0.5 * eps, 0.5 * eps  # smoothed BCE targets
        self._consts = {}  # device -> (anchors, offsets) on it

    def _device_consts(self, dev: torch.device):
        """The anchors and cell offsets as tensors on ``dev``, copied once
        (a copy to the card waits for the work queued before it)."""
        if dev not in self._consts:
            self._consts[dev] = (
                torch.as_tensor(self.anchors_grid, device=dev),
                torch.as_tensor(OFFSETS, device=dev))
        return self._consts[dev]

    def __call__(self, feats, targets, tmask):
        h = self.hyp
        B = feats[0].shape[0]
        dev = feats[0].device
        anchors, offsets = self._device_consts(dev)
        assigns = assign_targets(targets.to(dev), tmask.to(dev),
                                 [(f.shape[1], f.shape[2]) for f in feats],
                                 anchors, h.anchor_t, offsets)
        scale = None
        if h.fl_gamma > 0:
            scale = qfocal_scale if h.qfl else focal_scale
        dp = self.mesh is not None and self.mesh.n_data > 1
        n_img = B  # the batch the loss is the mean over
        if dp:  # the global batch's denominators, one all-reduce
            from ..parallel.mesh import all_reduce_
            den = all_reduce_(torch.stack([a.mask.sum() for a in assigns]),
                              self.mesh.data_group).clamp(min=1.0)
            n_img = B * self.mesh.n_data
        lbox = lobj = lcls = torch.zeros((), device=dev)
        for i, (f, asg) in enumerate(zip(feats, assigns)):
            f = f.float()
            _, ny, nx, na, _ = f.shape
            ps = f[asg.b, asg.gj, asg.gi, asg.a]          # (K, 5+nc)

            pxy = torch.sigmoid(ps[:, 0:2]) * 2.0 - 0.5
            anc = anchors[i][asg.a]
            pwh = (torch.sigmoid(ps[:, 2:4]) * 2.0) ** 2 * anc
            ciou = box_iou_elementwise(torch.cat([pxy, pwh], -1),
                                       torch.cat([asg.txy, asg.twh], -1),
                                       xyxy=False, kind="ciou")
            lbox = lbox + ((((1.0 - ciou) * asg.mask).sum() / den[i]) if dp
                           else _masked_mean(1.0 - ciou, asg.mask))

            # objectness targets: scatter-max of the detached, clamped CIoU
            val = ((1.0 - h.gr) + h.gr * ciou.detach().clamp(min=0.0)) \
                * asg.mask
            cell = ((asg.b * ny + asg.gj) * nx + asg.gi) * na + asg.a
            tobj = torch.zeros(B * ny * nx * na, device=dev).scatter_reduce(
                0, cell, val, "amax", include_self=True).view(f.shape[:4])
            obj_losses = _bce_logits(f[..., 4], tobj, h.obj_pw)
            if scale is not None:
                obj_losses = obj_losses * scale(f[..., 4], tobj, h.fl_gamma)
            lobj = lobj + (obj_losses.sum() / (n_img * ny * nx * na) if dp
                           else obj_losses.mean()) * self.balance[i]

            if self.nc > 1:
                t_cls = self.cn + (self.cp - self.cn) * F.one_hot(
                    asg.cls, self.nc).float()
                cls_losses = _bce_logits(ps[:, 5:], t_cls, h.cls_pw)
                if scale is not None:
                    cls_losses = cls_losses * scale(ps[:, 5:], t_cls,
                                                    h.fl_gamma)
                lcls = lcls + ((cls_losses.mean(-1) * asg.mask).sum() / den[i]
                               if dp else _masked_mean(cls_losses.mean(-1),
                                                       asg.mask))

        lbox = lbox * h.box
        lobj = lobj * h.obj
        lcls = lcls * h.cls
        total = (lbox + lobj + lcls) * n_img * self.loss_mult
        return total, {"box": lbox, "obj": lobj, "cls": lcls, "total": total}
