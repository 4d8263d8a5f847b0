"""Plain reference of the eval protocol's host side: boxes back to the
native frame, the greedy matching of predictions to labels at ten IoU
thresholds, and the summary (YOLOv5 v5.0 test.py and utils/metrics.py).

- Matching, per image and per labelled class: each prediction of that
  class, in confidence order, claims its best-IoU label if the IoU is
  above 0.5 and the label is unclaimed; it is then correct at every
  threshold its IoU exceeds; the image is done once every label is
  claimed.
- AP per class and threshold: precision and recall over the predictions
  in confidence order, the precision envelope, integrated over 101 recall
  points (COCO); P and R at the confidence of the best mean F1 on a grid
  of 1000; mAP@0.5, mAP@0.75 and mAP@0.5:0.95 averaged over the classes
  with labels.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

IOUV = np.linspace(0.5, 0.95, 10)


def to_native(boxes: np.ndarray, gain: float, pad: Sequence[float],
              native_hw: Sequence[int]) -> np.ndarray:
    """xyxy canvas pixels -> native pixels, clipped to the frame."""
    out = boxes.astype(np.float64 if boxes.dtype == np.float64
                       else np.float32).copy()
    out[:, [0, 2]] = ((out[:, [0, 2]] - pad[0]) / gain).clip(0, native_hw[1])
    out[:, [1, 3]] = ((out[:, [1, 3]] - pad[1]) / gain).clip(0, native_hw[0])
    return out


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    w = np.clip(np.minimum(a[:, None, 2], b[None, :, 2])
                - np.maximum(a[:, None, 0], b[None, :, 0]), 0, None)
    h = np.clip(np.minimum(a[:, None, 3], b[None, :, 3])
                - np.maximum(a[:, None, 1], b[None, :, 1]), 0, None)
    inter = w * h
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-16)


def match(pboxes, pcls, tboxes, tcls) -> np.ndarray:
    """(n_pred, 10) bool: which predictions are true positives at each
    threshold. Predictions come in confidence order."""
    correct = np.zeros((len(pboxes), len(IOUV)), bool)
    if not len(pboxes) or not len(tboxes):
        return correct
    claimed: set = set()
    for c in np.unique(tcls):
        ti = np.flatnonzero(tcls == c)
        pi = np.flatnonzero(pcls == c)
        if not len(pi):
            continue
        ious = iou_matrix(pboxes[pi], tboxes[ti])
        best = ious.argmax(1)
        best_iou = ious[np.arange(len(pi)), best]
        for j in np.flatnonzero(best_iou > IOUV[0]):
            t = int(ti[best[j]])
            if t in claimed:
                continue
            claimed.add(t)
            correct[pi[j]] = best_iou[j] > IOUV
            if len(claimed) == len(tboxes):
                break
    return correct


def ap101(recall: np.ndarray, precision: np.ndarray) -> float:
    mrec = np.concatenate(([0.0], recall, [recall[-1] + 0.01]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    return float(np.trapezoid(np.interp(x, mrec, mpre), x))


def summary(stats: List[tuple]) -> Dict[str, float]:
    """{mp, mr, map50, map75, map} of per-image (correct, conf, pred_cls,
    label_cls) tuples."""
    tp = np.concatenate([s[0] for s in stats])
    conf = np.concatenate([s[1] for s in stats])
    pcls = np.concatenate([s[2] for s in stats])
    tcls = np.concatenate([np.asarray(s[3], float) for s in stats])
    if not len(tp) or not tp.any():
        return dict(mp=0.0, mr=0.0, map50=0.0, map75=0.0, map=0.0)
    order = np.argsort(-conf)  # ties in numpy's default order
    tp, conf, pcls = tp[order], conf[order], pcls[order]
    classes = np.unique(tcls)
    px = np.linspace(0, 1, 1000)
    ap = np.zeros((len(classes), tp.shape[1]))
    p = np.zeros((len(classes), 1000))
    r = np.zeros((len(classes), 1000))
    for ci, c in enumerate(classes):
        sel = pcls == c
        n_l = int((tcls == c).sum())
        if not sel.any() or not n_l:
            continue
        tpc = tp[sel].cumsum(0)
        fpc = (1 - tp[sel]).cumsum(0)
        rec = tpc / (n_l + 1e-16)
        prec = tpc / (tpc + fpc)
        r[ci] = np.interp(-px, -conf[sel], rec[:, 0], left=0)
        p[ci] = np.interp(-px, -conf[sel], prec[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j] = ap101(rec[:, j], prec[:, j])
    f1 = 2 * p * r / (p + r + 1e-16)
    i = f1.mean(0).argmax()
    return dict(mp=float(p[:, i].mean()), mr=float(r[:, i].mean()),
                map50=float(ap[:, 0].mean()), map75=float(ap[:, 5].mean()),
                map=float(ap.mean()))
