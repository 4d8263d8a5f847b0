"""Batched non-maximum suppression with fixed-size outputs.

Counterpart of multispectral_object_detection_tpu/ops/nms.py:

- optional prior labels (B, M, 5) [cls, x, y, w, h] appended as
  unit-objectness, one-hot candidates (the ``--save-hybrid`` path);
- candidates: conf = obj * cls, confidence gating, optional multi-label
  expansion and class filtering;
- top-k by a stable descending sort, so tied scores keep ascending index
  order, as ``jax.lax.top_k`` does (``torch.topk`` orders ties otherwise);
- class-offset trick (boxes + cls * 4096) for per-class NMS in one pass;
- greedy argmax-and-suppress, a loop over iterations vectorised across the
  batch, ties to the lower index, stopping once no image has a candidate
  (or, ``fixed_trip``, after ``max_det`` iterations with no host read);
- optional weighted merge: each kept box becomes the score-weighted mean
  of the candidates that overlap it above the IoU threshold (in
  class-offset space), for 1 < candidates < 3000 per image; ``redundant``
  then drops kept boxes with no supporter but themselves;
- fixed ``max_det`` outputs with a validity mask.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .boxes import pairwise_iou, xywh_to_xyxy

_MAX_WH = 4096.0  # class-offset stride
_NEG = -1e9
_EXIT_CHECK_EVERY = 8  # iterations between host checks for early exit
_MERGE_MAX_CAND = 3000  # the merge runs for 1 < candidates < this


class Detections(NamedTuple):
    """Fixed-size per-image detections."""

    boxes: torch.Tensor    # (B, max_det, 4) xyxy, inference-canvas pixels
    scores: torch.Tensor   # (B, max_det)
    classes: torch.Tensor  # (B, max_det) int32
    valid: torch.Tensor    # (B, max_det) bool


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, K, ...) rows picked by idx (B, k) -> (B, k, ...)."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _suppress(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
              max_det: int, fixed_trip: bool = False):
    """Greedy NMS over (B, K, 4)/(B, K) -> kept indices (B, max_det),
    validity (B, max_det) and the number of iterations run.

    An iteration after an image's last candidate changes nothing for it,
    so the loop may check for its early exit only every few iterations
    (each check is a device-to-host sync). With ``fixed_trip`` it runs all
    ``max_det`` iterations and reads nothing back to the host (a graph
    that ``torch.export`` can trace), with the same results: the IoU of
    every pair of candidates is computed once (B, K, K) and each iteration
    reads the row of its pick, and since an image that has run out of
    candidates keeps none after, iteration t fills output slot t."""
    B = scores.shape[0]
    rows = torch.arange(B, device=scores.device)
    work = scores.clone()
    if fixed_trip:
        iou_all = pairwise_iou(boxes, boxes)
        picks, kept = [], []
        for _ in range(max_det):
            v, i = work.max(dim=1)  # first max wins ties
            keep = v > _NEG / 2
            work = torch.where(iou_all[rows, i] > iou_thres, _NEG, work)
            work = work.scatter(1, i[:, None], _NEG)
            picks.append(torch.where(keep, i, 0))
            kept.append(keep)
        return torch.stack(picks, 1), torch.stack(kept, 1), max_det
    idxs = torch.zeros((B, max_det), dtype=torch.long, device=scores.device)
    vals = torch.zeros((B, max_det), dtype=torch.bool, device=scores.device)
    n = torch.zeros((B,), dtype=torch.long, device=scores.device)
    it = 0
    while it < max_det:
        if it % _EXIT_CHECK_EVERY == 0 and not bool(
                (work.amax(dim=1) > _NEG / 2).any()):
            break
        it += 1
        v, i = work.max(dim=1)  # first max wins ties
        keep = v > _NEG / 2
        iou = pairwise_iou(boxes[rows, i][:, None, :], boxes)[:, 0]
        work = torch.where(iou > iou_thres, _NEG, work)
        work[rows, i] = _NEG
        idxs[rows, n] = torch.where(keep, i, 0)
        vals[rows, n] = keep
        n += keep.long()
    return idxs, vals, it


def _with_labels(pred: torch.Tensor, labels: torch.Tensor,
                 labels_mask: torch.Tensor, nc: int) -> torch.Tensor:
    """pred (B, N, 5+nc) with the prior labels appended as rows
    [x, y, w, h, 1, one-hot(cls)] (objectness 0 where masked out)."""
    labels = labels.to(pred.device, torch.float32)
    lab = torch.zeros(labels.shape[:2] + (pred.shape[-1],), device=pred.device)
    lab[..., :4] = labels[..., 1:5]
    lab[..., 4] = (torch.as_tensor(labels_mask, device=pred.device) > 0).float()
    cls = labels[..., 0].to(torch.int32)  # truncation, as astype(int32)
    lab[..., 5:5 + nc] = (cls[..., None] == torch.arange(
        nc, dtype=torch.int32, device=pred.device)).float()
    return torch.cat([pred, lab], dim=1)


def _merge(bxs: torch.Tensor, shifted: torch.Tensor, scores: torch.Tensor,
           idxs: torch.Tensor, vals: torch.Tensor, iou_thres: float,
           redundant: bool):
    """Weighted merge of the kept boxes, one image at a time (the
    (max_det, K) IoU of a whole eval batch would take about a GB).
    Zero-score slots (below the gate, padding) neither weigh in nor count
    as supporters. Returns the output boxes (B, max_det, 4) and validity."""
    out, keep = [], []
    for b in range(bxs.shape[0]):
        cand_w = torch.where(scores[b] > 0.0, scores[b], 0.0)      # (K,)
        n_cand = int((cand_w > 0.0).sum())
        kept = bxs[b, idxs[b]]
        if not 1 < n_cand < _MERGE_MAX_CAND:
            out.append(kept)
            keep.append(vals[b])
            continue
        sup = (pairwise_iou(shifted[b, idxs[b]], shifted[b]) > iou_thres) \
            & (cand_w > 0.0)[None, :]                              # (max_det, K)
        w = sup.float() * cand_w[None, :]
        out.append((w @ bxs[b]) / w.sum(dim=1, keepdim=True).clamp(min=1e-9))
        keep.append(vals[b] & (sup.sum(dim=1) > 1) if redundant else vals[b])
    return torch.stack(out), torch.stack(keep)


def batched_nms(pred: torch.Tensor, *, conf_thres: float = 0.25,
                iou_thres: float = 0.45, nc: Optional[int] = None,
                multi_label: bool = False, agnostic: bool = False,
                max_det: int = 300, top_k: int = 4096,
                class_mask=None, labels=None, labels_mask=None,
                merge: bool = False, redundant: bool = True,
                stats: Optional[dict] = None,
                fixed_trip: bool = False) -> Detections:
    """Batched NMS on decoded predictions (B, N, 5+nc) [xywh, obj, cls...].

    class_mask: optional (nc,) bool, keep only these classes.
    labels/labels_mask: optional (B, M, 5)/(B, M) prior labels in canvas
    pixels, injected as unit-confidence candidates.
    merge: weighted box merging; ``redundant`` drops merged boxes without a
    supporting neighbour.
    stats: optional dict to which the candidates past the confidence gate
    (summed over the batch, a device tensor: no host sync) and the
    suppression iterations run are added, under "candidates" and
    "iterations".
    fixed_trip: run all ``max_det`` suppression iterations without the
    early exit's host reads (the exported graph's form; same results)."""
    pred = pred.float()
    if nc is None:
        nc = pred.shape[-1] - 5
    if labels is not None:
        pred = _with_labels(pred, torch.as_tensor(labels),
                            labels_mask, nc)
    B, N, no = pred.shape
    dev = pred.device
    if class_mask is not None:
        class_mask = torch.as_tensor(class_mask, dtype=torch.bool, device=dev)
    obj = pred[..., 4]
    boxes_xyxy = xywh_to_xyxy(pred[..., :4])

    if nc > 1 and multi_label:
        # all (box, class) pairs above threshold
        conf = obj[..., None] * pred[..., 5:]                 # (B, N, nc)
        ok = (conf > conf_thres) & (obj > conf_thres)[..., None]
        if class_mask is not None:
            ok = ok & class_mask
        flat = torch.where(ok, conf, 0.0).reshape(B, N * nc)
        cls_of = torch.arange(nc, dtype=torch.int32, device=dev).repeat(N)
        cls_of = cls_of.expand(B, -1)
        box_of = torch.arange(N, device=dev).repeat_interleave(nc)
    else:
        # best class only
        if nc > 1:
            conf_c = obj[..., None] * pred[..., 5:]
            if class_mask is not None:
                conf_c = torch.where(class_mask, conf_c, 0.0)
            flat, cls_of = conf_c.max(dim=-1)  # first max wins ties
            cls_of = cls_of.int()
        else:
            flat = obj * pred[..., 5]
            cls_of = torch.zeros((B, N), dtype=torch.int32, device=dev)
        flat = torch.where((flat > conf_thres) & (obj > conf_thres), flat, 0.0)
        box_of = torch.arange(N, device=dev)

    k = min(top_k, flat.shape[1])
    scores, sel = torch.sort(flat, dim=1, descending=True, stable=True)
    scores, sel = scores[:, :k], sel[:, :k]
    cls = _gather(cls_of, sel)
    bxs = _gather(boxes_xyxy, box_of[sel])
    scores = torch.where(scores > 0.0, scores, _NEG)

    shifted = bxs if agnostic else bxs + (cls.float() * _MAX_WH)[..., None]
    idxs, vals, iters = _suppress(shifted, scores, iou_thres, max_det,
                                  fixed_trip)
    if stats is not None:
        stats["candidates"] = stats.get("candidates", 0) + (scores > 0).sum()
        stats["iterations"] = stats.get("iterations", 0) + iters
    if merge:
        out_boxes, vals = _merge(bxs, shifted, scores, idxs, vals, iou_thres,
                                 redundant)
    else:
        out_boxes = _gather(bxs, idxs)

    return Detections(
        boxes=torch.where(vals[..., None], out_boxes, 0.0),
        scores=torch.where(vals, _gather(scores, idxs), 0.0),
        classes=torch.where(vals, _gather(cls, idxs), 0).int(),
        valid=vals,
    )
