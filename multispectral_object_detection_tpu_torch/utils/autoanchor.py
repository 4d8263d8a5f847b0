"""Anchor audit and re-clustering, in numpy.

The port's copy of multispectral_object_detection_tpu/utils/autoanchor.py,
with the same seeded draws:

- ``check_anchors``: best possible recall (BPR) of the anchors over the
  training labels' sizes (jittered by U(0.9, 1.1)); below 0.98 the anchors
  are re-clustered and kept when they fit better;
- ``kmean_anchors``: whitened k-means on the sizes, then 1000 generations
  of mutation under the anchor-ratio fitness.
"""

from __future__ import annotations

import logging
from typing import Sequence

import numpy as np

logger = logging.getLogger(__name__)


def _metric(wh: np.ndarray, anchors: np.ndarray):
    """Per target and anchor the worse of the w and h ratios (x), and per
    target the best anchor's (best)."""
    r = wh[:, None] / anchors[None]
    x = np.minimum(r, 1.0 / r).min(2)
    return x, x.max(1)


def anchor_fitness(anchors: np.ndarray, wh: np.ndarray,
                   thr: float = 4.0) -> float:
    """Mean best ratio over the targets whose best ratio passes 1/thr."""
    _, best = _metric(wh, anchors)
    return float((best * (best > 1.0 / thr)).mean())


def best_possible_recall(anchors: np.ndarray, wh: np.ndarray,
                         thr: float = 4.0) -> tuple:
    """(BPR, anchors above the threshold per target)."""
    x, best = _metric(wh, anchors)
    return float((best > 1.0 / thr).mean()), float((x > 1.0 / thr).sum(1)
                                                    .mean())


def dataset_wh(labels: Sequence[np.ndarray], img_size: int,
               rng: np.random.Generator) -> np.ndarray:
    """Pixel (w, h) of every label row at ``img_size``, jittered by
    U(0.9, 1.1) per row."""
    whs = [lab[:, 3:5] * img_size * rng.uniform(0.9, 1.1, size=(len(lab), 1))
           for lab in labels if len(lab)]
    return np.concatenate(whs, 0) if whs else np.zeros((0, 2))


def kmean_anchors(wh: np.ndarray, n: int = 9, thr: float = 4.0,
                  gen: int = 1000, seed: int = 0) -> np.ndarray:
    """k-means and mutation of anchors; (n, 2) sorted by area. Raises
    ValueError with fewer than n sizes above 2 px."""
    rng = np.random.default_rng(seed)
    wh = wh[(wh >= 2.0).any(1)]
    if len(wh) < n:
        raise ValueError(f"need >= {n} labels to cluster, got {len(wh)}")
    std = wh.std(0)
    x = wh / std
    centers = x[rng.choice(len(x), n, replace=False)]
    for _ in range(30):
        assign = ((x[:, None] - centers[None]) ** 2).sum(-1).argmin(1)
        for j in range(n):
            pts = x[assign == j]
            if len(pts):
                centers[j] = pts.mean(0)
    k = centers * std
    f = anchor_fitness(k, wh, thr)
    sh = k.shape
    mp, sigma = 0.9, 0.1
    for _ in range(gen):
        v = np.ones(sh)
        while (v == 1).all():
            v = ((rng.random(sh) < mp) * rng.random() *
                 rng.normal(size=sh) * sigma + 1).clip(0.3, 3.0)
        kg = (k * v).clip(min=2.0)
        fg = anchor_fitness(kg, wh, thr)
        if fg > f:
            f, k = fg, kg.copy()
    return k[np.argsort(k.prod(1))]


def check_anchors(labels: Sequence[np.ndarray], anchors_px: np.ndarray,
                  img_size: int, thr: float = 4.0,
                  seed: int = 0) -> np.ndarray:
    """The (nl, na, 2) pixel anchors to train with: these, or re-clustered
    ones when BPR < 0.98 and the new ones fit better."""
    wh = dataset_wh(labels, img_size, np.random.default_rng(seed))
    if not len(wh):
        return anchors_px
    flat = anchors_px.reshape(-1, 2)
    bpr, aat = best_possible_recall(flat, wh, thr)
    logger.info(f"autoanchor: BPR {bpr:.4f}, {aat:.2f} anchors/target")
    if bpr >= 0.98:
        return anchors_px
    logger.info("autoanchor: BPR < 0.98, re-clustering...")
    try:
        new = kmean_anchors(wh, n=flat.shape[0], thr=thr, seed=seed)
    except ValueError as e:
        logger.warning(f"autoanchor failed: {e}")
        return anchors_px
    if anchor_fitness(new, wh, thr) > anchor_fitness(flat, wh, thr):
        return new.reshape(anchors_px.shape)
    return anchors_px
