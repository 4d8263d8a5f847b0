"""Plain greedy NMS, per image, on the host.

The YOLOv5 protocol written out directly: confidence = objectness x class
probability, kept where both objectness and confidence pass ``conf``; the
best class only (or, with ``multi_label`` and several classes, every class
that passes); a stable sort by confidence, descending, cut to ``top_k``;
boxes offset by class x 4096 so that classes never suppress each other;
then, up to ``max_det`` times, keep the best remaining candidate and drop
every candidate whose IoU with it exceeds ``iou``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

MAX_WH = 4096.0


def xywh_to_xyxy(b: np.ndarray) -> np.ndarray:
    cx, cy, w, h = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    hw, hh = w * np.float32(0.5), h * np.float32(0.5)
    return np.stack([cx - hw, cy - hh, cx + hw, cy + hh], 1)


def iou_one(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """IoU of one xyxy box with each row of ``boxes``."""
    iw = np.clip(np.minimum(box[2], boxes[:, 2])
                 - np.maximum(box[0], boxes[:, 0]), 0, None)
    ih = np.clip(np.minimum(box[3], boxes[:, 3])
                 - np.maximum(box[1], boxes[:, 1]), 0, None)
    inter = iw * ih
    a = (box[2] - box[0]) * (box[3] - box[1])
    b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / (a + b - inter + np.float32(1e-7))


def nms_image(pred: np.ndarray, conf: float, iou: float, max_det: int,
              top_k: int, multi_label: bool = False
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """pred (N, 5 + nc) float32 decoded rows of one image -> kept boxes
    (k, 4) xyxy, scores (k,), classes (k,), best first."""
    nc = pred.shape[1] - 5
    obj = pred[:, 4]
    if nc > 1 and multi_label:
        c = obj[:, None] * pred[:, 5:]
        ok = (c > conf) & (obj > conf)[:, None]
        score = np.where(ok, c, 0).reshape(-1)
        cls = np.tile(np.arange(nc), len(pred))
        box_of = np.repeat(np.arange(len(pred)), nc)
    else:
        c = obj[:, None] * pred[:, 5:]
        cls = c.argmax(1) if nc > 1 else np.zeros(len(pred), np.int64)
        score = c[np.arange(len(pred)), cls]
        score = np.where((score > conf) & (obj > conf), score, 0)
        box_of = np.arange(len(pred))
    order = np.argsort(-score, kind="stable")[:top_k]
    order = order[score[order] > 0]
    boxes = xywh_to_xyxy(pred[box_of[order], :4])
    score, cls = score[order], cls[order]
    shifted = boxes + (cls.astype(np.float32) * np.float32(MAX_WH))[:, None]
    alive = np.ones(len(order), bool)
    keep: List[int] = []
    while len(keep) < max_det:
        live = np.flatnonzero(alive)
        if not len(live):
            break
        i = live[0]  # the sort put the best first, ties by position
        keep.append(i)
        alive &= ~(iou_one(shifted[i], shifted) > iou)
        alive[i] = False
    k = np.asarray(keep, np.int64)
    return boxes[k], score[k], cls[k]
