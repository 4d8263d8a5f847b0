"""COCO-protocol bbox evaluation (the pycocotools.cocoeval bbox protocol).

The port's own copy of multispectral_object_detection_tpu/utils/cocoeval.py
(host numpy, the same arithmetic):

- 10 IoU thresholds 0.50:0.05:0.95, greedy per-image matching in descending
  score order, each GT matched at most once, best-IoU GT preferred;
- top-100 detections per image;
- 101-point interpolated precision averaged over recall points, categories
  (with >= 1 GT) and thresholds.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)


def _iou_xywh(det: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """IoU matrix between det (D, 4) and gt (G, 4), xywh top-left boxes."""
    d = det.copy()
    g = gt.copy()
    d[:, 2:] += d[:, :2]
    g[:, 2:] += g[:, :2]
    ix = (np.minimum(d[:, None, 2], g[None, :, 2])
          - np.maximum(d[:, None, 0], g[None, :, 0])).clip(0)
    iy = (np.minimum(d[:, None, 3], g[None, :, 3])
          - np.maximum(d[:, None, 1], g[None, :, 1])).clip(0)
    inter = ix * iy
    area_d = (d[:, 2] - d[:, 0]) * (d[:, 3] - d[:, 1])
    area_g = (g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1])
    union = area_d[:, None] + area_g[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def _match_image(dscores, ious, n_gt: int, thr: float) -> np.ndarray:
    """Greedy COCO matching for one image/category at one threshold.

    dscores sorted desc; ious (D, G). Returns tp flags (D,)."""
    tp = np.zeros(len(dscores), dtype=bool)
    gt_used = np.zeros(n_gt, dtype=bool)
    for di in range(len(dscores)):
        best, best_g = thr - 1e-10, -1
        for gi in range(n_gt):
            if gt_used[gi]:
                continue
            if ious[di, gi] > best:
                best, best_g = ious[di, gi], gi
        if best_g >= 0:
            gt_used[best_g] = True
            tp[di] = True
    return tp


def coco_eval_bbox(gt_records: Sequence[dict], det_records: Sequence[dict],
                   max_det: int = 100) -> Dict[str, float]:
    """Evaluate detections against ground truth, COCO bbox protocol.

    gt_records:  [{image_id, category_id, bbox [x,y,w,h]}, ...]
    det_records: [{image_id, category_id, bbox, score}, ...]
    Returns {"AP", "AP50", "AP75"} (area=all, maxDet=100).
    """
    gts = defaultdict(list)   # (img, cat) -> [bbox]
    dets = defaultdict(list)  # (img, cat) -> [(score, bbox)]
    cats = set()
    imgs = set()
    for g in gt_records:
        gts[(g["image_id"], g["category_id"])].append(g["bbox"])
        cats.add(g["category_id"])
        imgs.add(g["image_id"])
    for d in det_records:
        dets[(d["image_id"], d["category_id"])].append(
            (float(d["score"]), d["bbox"]))
        imgs.add(d["image_id"])

    T = len(IOU_THRS)
    ap = np.full((T, len(cats)), np.nan)

    for ci, cat in enumerate(sorted(cats)):
        scores_all: List[np.ndarray] = []
        tp_all: List[List[np.ndarray]] = [[] for _ in range(T)]
        npig = 0
        for img in imgs:
            gt = np.asarray(gts.get((img, cat), ()), np.float64).reshape(-1, 4)
            dd = sorted(dets.get((img, cat), ()), key=lambda x: -x[0])[:max_det]
            npig += len(gt)
            if not dd:
                continue
            dscores = np.asarray([s for s, _ in dd])
            dboxes = np.asarray([b for _, b in dd], np.float64)
            ious = _iou_xywh(dboxes, gt) if len(gt) else \
                np.zeros((len(dd), 0))
            scores_all.append(dscores)
            for ti, thr in enumerate(IOU_THRS):
                tp_all[ti].append(_match_image(dscores, ious, len(gt), thr))
        if npig == 0:
            continue
        if not scores_all:
            ap[:, ci] = 0.0
            continue
        scores = np.concatenate(scores_all)
        order = np.argsort(-scores, kind="mergesort")
        for ti in range(T):
            tp = np.concatenate(tp_all[ti])[order]
            tps = np.cumsum(tp)
            fps = np.cumsum(~tp)
            rc = tps / npig
            pr = tps / np.maximum(tps + fps, 1e-12)
            # monotone precision envelope (pycocotools cocoeval.py)
            for i in range(len(pr) - 1, 0, -1):
                pr[i - 1] = max(pr[i - 1], pr[i])
            # sample at the 101 recall points
            inds = np.searchsorted(rc, REC_THRS, side="left")
            q = np.zeros(len(REC_THRS))
            valid = inds < len(pr)
            q[valid] = pr[inds[valid]]
            ap[ti, ci] = q.mean()

    def mean_at(ti=None):
        a = ap if ti is None else ap[ti:ti + 1]
        a = a[~np.isnan(a)]
        return float(a.mean()) if a.size else 0.0

    return {"AP": mean_at(), "AP50": mean_at(0), "AP75": mean_at(5)}
