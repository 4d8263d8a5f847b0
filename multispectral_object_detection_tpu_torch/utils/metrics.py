"""Detection metrics: AP per class, mAP@[.5:.95], fitness, TP matching.

The port's own copy of multispectral_object_detection_tpu/utils/metrics.py
(host numpy, the same arithmetic): per-class PR curves sampled at 1000
confidence points, 101-point interpolation of the precision envelope, P/R
at the max-F1 confidence, mAP75 from the 6th of the 10 IoU thresholds,
greedy per-image TP matching, the log-average miss rate and the confusion
matrix.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)


def fitness(p: float, r: float, map50: float, map_: float) -> float:
    """Model-selection scalar: 0.1*mAP50 + 0.9*mAP (utils/metrics.py:12)."""
    return 0.1 * map50 + 0.9 * map_


def _box_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=-1)
    area_a = np.prod(a[:, 2:] - a[:, :2], axis=-1)
    area_b = np.prod(b[:, 2:] - b[:, :2], axis=-1)
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-16)


def match_predictions(pred_boxes: np.ndarray, pred_cls: np.ndarray,
                      true_boxes: np.ndarray, true_cls: np.ndarray,
                      iouv: np.ndarray = IOU_THRESHOLDS) -> np.ndarray:
    """Greedy per-image TP matrix (n_pred, n_iou) — test.py:184-215 semantics.

    Per target class: each prediction's best-IoU target is claimed in
    prediction order (predictions are assumed conf-sorted, as NMS emits
    them); a target can be claimed once; a claim at IoU > 0.5 marks the
    prediction correct at every threshold its IoU clears.
    """
    correct = np.zeros((pred_boxes.shape[0], iouv.shape[0]), dtype=bool)
    if true_boxes.shape[0] == 0 or pred_boxes.shape[0] == 0:
        return correct
    detected: set[int] = set()
    for c in np.unique(true_cls):
        ti = np.nonzero(true_cls == c)[0]
        pi = np.nonzero(pred_cls == c)[0]
        if pi.size == 0:
            continue
        ious_mat = _box_iou_np(pred_boxes[pi], true_boxes[ti])
        best = ious_mat.argmax(1)
        best_iou = ious_mat[np.arange(pi.size), best]
        n_detected_c = 0
        for j in np.nonzero(best_iou > iouv[0])[0]:
            d = int(ti[best[j]])
            if d not in detected:
                detected.add(d)
                n_detected_c += 1
                correct[pi[j]] = best_iou[j] > iouv
                if len(detected) == true_boxes.shape[0]:
                    break
    return correct


def ap_per_class(tp: np.ndarray, conf: np.ndarray, pred_cls: np.ndarray,
                 target_cls: np.ndarray, curves: bool = False):
    """Per-class AP over the IoU-threshold axis (utils/metrics.py:18-80).

    Returns (p, r, ap, f1, unique_classes): p/r/f1 at the max-F1 confidence,
    ap with shape (n_classes_present, n_iou). With `curves=True` a sixth
    element is appended: a dict of the plottable curves the reference emits
    with plot=True (metrics.py:29-76) — px (confidence grid), pr_px/pr_py
    (per-class precision-over-recall at IoU .5), and the per-class
    p/r/f1-over-confidence curves.
    """
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]

    classes = np.unique(target_cls)
    nc = classes.shape[0]
    px = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, tp.shape[1]))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    pr_py = []

    for ci, c in enumerate(classes):
        sel = pred_cls == c
        n_l = int((target_cls == c).sum())
        n_p = int(sel.sum())
        if n_p == 0 or n_l == 0:
            pr_py.append(np.zeros_like(px))
            continue
        fpc = (1 - tp[sel]).cumsum(0)
        tpc = tp[sel].cumsum(0)
        recall = tpc / (n_l + 1e-16)
        precision = tpc / (tpc + fpc)
        r_curve[ci] = np.interp(-px, -conf[sel], recall[:, 0], left=0)
        p_curve[ci] = np.interp(-px, -conf[sel], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j] = compute_ap(recall[:, j], precision[:, j])
        # precision over the recall grid at IoU .5 (metrics.py:61)
        mrec = np.concatenate(([0.0], recall[:, 0], [recall[-1, 0] + 0.01]))
        mpre = np.concatenate(([1.0], precision[:, 0], [0.0]))
        mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
        pr_py.append(np.interp(px, mrec, mpre))

    f1 = 2 * p_curve * r_curve / (p_curve + r_curve + 1e-16)
    i = f1.mean(0).argmax()
    out = (p_curve[:, i], r_curve[:, i], ap, f1[:, i],
           classes.astype(np.int32))
    if curves:
        out = out + (dict(px=px, pr_px=px, pr_py=pr_py, p=p_curve,
                          r=r_curve, f1=f1),)
    return out


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """101-point interpolated AP of one PR curve (utils/metrics.py:83-108)."""
    mrec = np.concatenate(([0.0], recall, [recall[-1] + 0.01]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    return float(np.trapezoid(np.interp(x, mrec, mpre), x))


def summarize_stats(stats: List[Tuple[np.ndarray, np.ndarray, np.ndarray, list]],
                    nc: int, curves: bool = False) -> Dict[str, object]:
    """Aggregate per-image (correct, conf, pred_cls, target_cls) tuples into
    the headline numbers (test.py:227-234). `curves=True` adds a 'curves'
    entry with the plottable PR/P/R/F1 curves (see ap_per_class)."""
    if not stats:
        return dict(mp=0.0, mr=0.0, map50=0.0, map75=0.0, map=0.0,
                    per_class={}, nt=np.zeros(nc, dtype=int))
    tp = np.concatenate([s[0] for s in stats], 0)
    conf = np.concatenate([s[1] for s in stats], 0)
    pcls = np.concatenate([s[2] for s in stats], 0)
    tcls = np.concatenate([np.asarray(s[3], dtype=np.float64) for s in stats], 0)
    if tp.size == 0 or not tp.any():
        return dict(mp=0.0, mr=0.0, map50=0.0, map75=0.0, map=0.0,
                    per_class={}, nt=np.bincount(tcls.astype(int), minlength=nc))
    res = ap_per_class(tp, conf, pcls, tcls, curves=curves)
    p, r, ap, f1, cls_ids = res[:5]
    ap50, ap75, ap_mean = ap[:, 0], ap[:, 5], ap.mean(1)
    per_class = {int(c): dict(p=float(p[i]), r=float(r[i]), ap50=float(ap50[i]),
                              ap75=float(ap75[i]), ap=float(ap_mean[i]))
                 for i, c in enumerate(cls_ids)}
    out = dict(
        mp=float(p.mean()), mr=float(r.mean()), map50=float(ap50.mean()),
        map75=float(ap75.mean()), map=float(ap_mean.mean()),
        per_class=per_class,
        nt=np.bincount(tcls.astype(int), minlength=nc),
    )
    if curves:
        out["curves"] = dict(res[5], ap=ap, cls_ids=cls_ids)
    return out


def log_average_miss_rate(tp: np.ndarray, conf: np.ndarray, n_images: int,
                          n_gt: int) -> float:
    """Log-average miss rate over FPPI in [1e-2, 1] (the LLVIP pedestrian
    metric in the reference README table; 9 log-spaced reference points).

    tp: (n_pred,) bool at IoU 0.5 (first column of the eval TP matrix),
    conf-sorted or not (sorted internally).
    """
    if n_gt == 0 or tp.size == 0:
        return 1.0
    order = np.argsort(-conf)
    tp = tp[order].astype(float)
    tpc = np.cumsum(tp)
    fpc = np.cumsum(1.0 - tp)
    miss = 1.0 - tpc / n_gt
    fppi = fpc / max(n_images, 1)
    refs = np.logspace(-2.0, 0.0, 9)
    vals = []
    for r in refs:
        idx = np.nonzero(fppi <= r)[0]
        vals.append(miss[idx[-1]] if idx.size else 1.0)
    vals = np.clip(np.asarray(vals), 1e-10, None)
    return float(np.exp(np.mean(np.log(vals))))


class ConfusionMatrix:
    """IoU-matched detection/GT confusion matrix (utils/metrics.py:111-183)."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.matrix = np.zeros((nc + 1, nc + 1))
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres

    def process_batch(self, pred_boxes, pred_conf, pred_cls, true_boxes, true_cls):
        keep = pred_conf > self.conf
        pred_boxes, pred_cls = pred_boxes[keep], pred_cls[keep].astype(int)
        gt_cls = true_cls.astype(int)
        iou = _box_iou_np(true_boxes, pred_boxes) if (
            len(true_boxes) and len(pred_boxes)) else np.zeros((len(true_boxes), len(pred_boxes)))
        x = np.nonzero(iou > self.iou_thres)
        if x[0].size:
            m = np.stack([x[0], x[1], iou[x]], 1)
            if x[0].size > 1:
                m = m[m[:, 2].argsort()[::-1]]
                m = m[np.unique(m[:, 1], return_index=True)[1]]
                m = m[m[:, 2].argsort()[::-1]]
                m = m[np.unique(m[:, 0], return_index=True)[1]]
        else:
            m = np.zeros((0, 3))
        matched_gt = m[:, 0].astype(int)
        matched_pred = m[:, 1].astype(int)
        for i, gc in enumerate(gt_cls):
            if i in matched_gt:
                pc = pred_cls[matched_pred[list(matched_gt).index(i)]]
                self.matrix[pc, gc] += 1
            else:
                self.matrix[self.nc, gc] += 1  # background FN
        for j, pc in enumerate(pred_cls):
            if j not in matched_pred:
                self.matrix[pc, self.nc] += 1  # background FP
