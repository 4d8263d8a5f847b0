"""Batched non-maximum suppression with fixed-size outputs.

Counterpart of multispectral_object_detection_tpu/ops/nms.py:

- optional prior labels (B, M, 5) [cls, x, y, w, h] appended as
  unit-objectness, one-hot candidates (the ``--save-hybrid`` path);
- candidates: conf = obj * cls, confidence gating, optional multi-label
  expansion and class filtering;
- top-k by a stable descending sort, so tied scores keep ascending index
  order, as ``jax.lax.top_k`` does (``torch.topk`` orders ties otherwise);
- class-offset trick (boxes + cls * 4096) for per-class NMS in one pass;
- greedy argmax-and-suppress, ties to the lower index: on CUDA tensors
  kernel K3 ``nms_suppress`` (kernels/csrc/nms.cu), every step of every
  image in one launch with no host read; on CPU tensors, and with
  ``fixed_trip`` (the exported graph), its plain twin, a loop over steps
  vectorised across the batch that stops once no image has a candidate
  (or, ``fixed_trip``, after ``max_det`` steps with no host read);
- optional weighted merge: each kept box becomes the score-weighted mean
  of the candidates that overlap it above the IoU threshold (in
  class-offset space), for 1 < candidates < 3000 per image; ``redundant``
  then drops kept boxes with no supporter but themselves;
- fixed ``max_det`` outputs with a validity mask.

Spans (utils/tracing): ``nms`` around the whole call, ``nms.select``
(gate, sort, gather), ``nms.suppress`` (K3's launch, or the plain loop)
and, in the plain loop without ``fixed_trip``, ``sync.nms_exit`` for each
early-exit check's wait on the device. Counters: ``nms.candidates``
(candidates past the gate; 0 when ``max_det`` is 0) and
``nms.iterations``. On CUDA both are device tensors that K3 wrote (the
sum of its per-image counts, and the batch's largest number of picks) and
``k3.nms_suppress`` counts K3's launches, one a call (none for an
empty batch). On the CPU
``nms.candidates`` is read by the first exit check, so counting adds no
device work, and ``nms.iterations`` counts the loop's steps, which may
run up to 7 past the last pick (a check every 8 steps).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels import check_args, launch, on_cpu, ptr, require
from ..utils.tracing import count, span
from .boxes import pairwise_iou, xywh_to_xyxy

COUNTER = "k3.nms_suppress"

_MAX_WH = 4096.0  # class-offset stride
_NEG = -1e9
_EXIT_CHECK_EVERY = 8  # iterations between host checks for early exit
_MERGE_MAX_CAND = 3000  # the merge runs for 1 < candidates < this
K3_MAX_K = (1 << 30) - 1  # K3's candidates per image (csrc/nms.cu)
K3_MAX_DET = (1 << 31) - 1  # K3's max_det, an int of its C entry point


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


def _suppress_plain(boxes: torch.Tensor, scores: torch.Tensor,
                    iou_thres: float, max_det: int, fixed_trip: bool = False):
    """Greedy NMS over (B, K, 4)/(B, K) on any device, K3's plain twin ->
    kept indices (B, max_det), validity (B, max_det), the number of
    iterations run and the number of candidates (scores above ``_NEG``:
    an int, or with ``fixed_trip`` a device tensor; 0 when ``max_det`` is
    0).

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
        return (torch.stack(picks, 1), torch.stack(kept, 1), max_det,
                (scores > _NEG / 2).sum())
    idxs = torch.zeros((B, max_det), dtype=torch.long, device=scores.device)
    vals = torch.zeros((B, max_det), dtype=torch.bool, device=scores.device)
    n = torch.zeros((B,), dtype=torch.long, device=scores.device)
    it = candidates = 0
    while it < max_det:
        if it % _EXIT_CHECK_EVERY == 0:
            left = (work > _NEG / 2).sum()  # the candidates not yet taken
            with span("sync.nms_exit"):
                left = int(left)
            if it == 0:
                candidates = left  # none taken yet: all past the gate
            if not left:
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
    return idxs, vals, it, candidates


def check_nms(boxes: torch.Tensor, scores: torch.Tensor, max_det: int) -> None:
    """Raise ValueError for arguments that K3 does not take. Reads shapes
    and dtypes only, so it runs on CPU or meta tensors."""
    require(scores.dim() == 2 and boxes.shape == scores.shape + (4,),
            f"nms_suppress: boxes {tuple(boxes.shape)} and scores "
            f"{tuple(scores.shape)} must be (B, K, 4) and (B, K)")
    require(boxes.dtype == scores.dtype == torch.float32,
            "nms_suppress: boxes and scores must be float32")
    require(scores.shape[1] <= K3_MAX_K,
            f"nms_suppress: K={scores.shape[1]} candidates, at most "
            f"{K3_MAX_K}")
    require(0 <= max_det <= K3_MAX_DET,
            f"nms_suppress: max_det={max_det}, at most {K3_MAX_DET}")


def nms_suppress(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
                 max_det: int):
    """Kernel ``nms_suppress`` (kernels/csrc/nms.cu), one launch, on
    ``_select``'s CUDA outputs -> kept indices (B, max_det), validity
    (B, max_det) and per image [candidates, picks] (B, 2) int64, as the
    plain loop gives them; ``iou_thres`` is compared as a float32. An
    empty batch has nothing to suppress: its empty outputs, no launch."""
    check_nms(boxes, scores, max_det)
    B, K = scores.shape
    dev = scores.device
    idxs = torch.empty((B, max_det), dtype=torch.long, device=dev)
    vals = torch.empty((B, max_det), dtype=torch.bool, device=dev)
    stats = torch.empty((B, 2), dtype=torch.long, device=dev)
    if B == 0:
        return idxs, vals, stats
    check_args("nms_suppress", boxes=boxes, scores=scores, idxs=idxs,
               vals=vals, stats=stats)
    launch("nms", "nms_suppress", dev, ptr(boxes), ptr(scores), B, K,
           max_det, float(iou_thres), ptr(idxs), ptr(vals), ptr(stats))
    count(COUNTER)
    return idxs, vals, stats


def _suppress(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
              max_det: int, fixed_trip: bool = False):
    """Greedy NMS -> kept indices (B, max_det), validity (B, max_det), the
    ``nms.iterations`` and ``nms.candidates`` counts: K3 on CUDA tensors
    (the batch's largest number of picks and the candidates, as device
    tensors; 0 for an empty batch, as the plain loop counts it), else
    ``_suppress_plain``."""
    if fixed_trip or on_cpu(boxes, scores):
        return _suppress_plain(boxes, scores, iou_thres, max_det, fixed_trip)
    idxs, vals, stats = nms_suppress(boxes, scores, iou_thres, max_det)
    picks = stats[:, 1].max() if len(stats) else stats.new_zeros(())
    return idxs, vals, picks, stats[:, 0].sum()


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


def _select(pred: torch.Tensor, conf_thres: float, nc: Optional[int],
            multi_label: bool, agnostic: bool, top_k: int, class_mask,
            labels, labels_mask):
    """The candidates past the confidence gate, top-k by score: boxes
    (B, k, 4) xyxy, the same in class-offset space, scores (B, k; _NEG
    where none) and classes (B, k)."""
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
    return bxs, shifted, scores, cls


def batched_nms(pred: torch.Tensor, *, conf_thres: float = 0.25,
                iou_thres: float = 0.45, nc: Optional[int] = None,
                multi_label: bool = False, agnostic: bool = False,
                max_det: int = 300, top_k: int = 4096,
                class_mask=None, labels=None, labels_mask=None,
                merge: bool = False, redundant: bool = True,
                fixed_trip: bool = False) -> Detections:
    """Batched NMS on decoded predictions (B, N, 5+nc) [xywh, obj, cls...].

    class_mask: optional (nc,) bool, keep only these classes.
    labels/labels_mask: optional (B, M, 5)/(B, M) prior labels in canvas
    pixels, injected as unit-confidence candidates.
    merge: weighted box merging; ``redundant`` drops merged boxes without a
    supporting neighbour.
    fixed_trip: run all ``max_det`` suppression iterations without the
    early exit's host reads (the exported graph's form; same results)."""
    with span("nms"):
        with span("nms.select"):
            bxs, shifted, scores, cls = _select(
                pred, conf_thres, nc, multi_label, agnostic, top_k,
                class_mask, labels, labels_mask)
        with span("nms.suppress"):
            idxs, vals, iters, candidates = _suppress(
                shifted, scores, iou_thres, max_det, fixed_trip)
        count("nms.candidates", candidates)
        count("nms.iterations", iters)
        if merge:
            out_boxes, vals = _merge(bxs, shifted, scores, idxs, vals,
                                     iou_thres, redundant)
        else:
            out_boxes = _gather(bxs, idxs)
        return Detections(
            boxes=torch.where(vals[..., None], out_boxes, 0.0),
            scores=torch.where(vals, _gather(scores, idxs), 0.0),
            classes=torch.where(vals, _gather(cls, idxs), 0).int(),
            valid=vals,
        )
