"""PyTorch port, batched NMS: kept detections identical to the JAX
package's batched_nms on the same decoded predictions, including tied
scores, where the order of the top-k decides which box survives; the
prior-label (``--save-hybrid``) and weighted-merge paths too. Validity,
classes and scores must be equal; boxes equal, or within 1e-5 relative
where the merge averages them (a sum in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multispectral_object_detection_tpu.ops.nms import (
    batched_nms as jax_batched_nms)
from multispectral_object_detection_tpu_torch.ops.boxes import (
    pairwise_iou, xywh_to_xyxy)
from multispectral_object_detection_tpu_torch.ops.nms import batched_nms
from multispectral_object_detection_tpu_torch.utils import tracing
from tests._torch_port import share_torch_threads  # noqa: F401


def _preds(rng, b, n, nc, wh=(10, 120)):
    """Decoded (b, n, 5+nc): xywh in a 640 canvas, obj, class probs."""
    xy = rng.uniform(50, 590, (b, n, 2))
    size = rng.uniform(*wh, (b, n, 2))
    obj = rng.uniform(0, 1, (b, n, 1))
    cls = rng.dirichlet(np.ones(nc), (b, n)) if nc > 1 else np.ones((b, n, 1))
    return np.concatenate([xy, size, obj, cls], -1).astype(np.float32)


def _tied(rng):
    """Clusters of overlapping boxes that all score exactly 0.5."""
    p = _preds(rng, 2, 96, 1, wh=(60, 80))
    p[..., 4] = 0.5
    p[..., :2] = np.round(p[..., :2] / 100) * 100 + rng.uniform(0, 5, (2, 96, 2))
    return p


def _bf16_ties(rng):
    """Scores rounded as a bf16 head rounds them: many exact ties."""
    p = _preds(rng, 2, 128, 2)
    p[..., 4:] = torch.from_numpy(p[..., 4:]).bfloat16().float().numpy()
    return p


def _full(rng):
    """A grid of disjoint confident boxes: more survivors than max_det."""
    g = np.stack(np.meshgrid(np.arange(16), np.arange(16)), -1).reshape(-1, 2)
    p = np.zeros((1, 256, 6), np.float32)
    p[0, :, :2] = g * 40 + 20
    p[0, :, 2:4] = 30
    p[0, :, 4] = rng.uniform(0.5, 1.0, 256)
    p[0, :, 5] = 1.0
    return p


def _mixed(rng):
    p = _preds(rng, 2, 64, 3)
    p[0, :, 4] = 0.0  # first image: nothing above threshold
    return p


def _hybrid(rng):
    """The ground truth as the only candidates (test_nms_metrics.py's
    test_nms_hybrid_labels_injected)."""
    pred = np.zeros((1, 4, 7), np.float32)
    labels = np.zeros((1, 2, 5), np.float32)
    labels[0, 0] = [1, 100, 100, 40, 40]
    labels[0, 1] = [0, 300, 300, 60, 60]
    return pred, labels, np.ones((1, 2), np.float32)


def _with_labels(rng, nc=3):
    """Random predictions plus padded label blocks (some rows masked out),
    labels overlapping predictions and each other."""
    pred = _preds(rng, 2, 120, nc)
    labels = np.zeros((2, 10, 5), np.float32)
    labels[..., 0] = rng.integers(0, nc, (2, 10))
    labels[..., 1:3] = pred[:, :10, :2] + rng.uniform(-5, 5, (2, 10, 2))
    labels[..., 3:5] = rng.uniform(20, 100, (2, 10, 2))
    lmask = np.zeros((2, 10), np.float32)
    lmask[0, :7] = 1.0
    lmask[1, :3] = 1.0
    return pred, labels, lmask


def _one_candidate(rng):
    p = np.zeros((1, 16, 6), np.float32)
    p[0, :, :4] = [100, 100, 40, 40]
    p[0, 3, 4:] = [0.9, 1.0]
    return p


def _many(rng):
    """3200 candidates above the gate: the merge is skipped."""
    p = _preds(rng, 1, 3200, 1)
    p[..., 4] = rng.uniform(0.3, 1.0, (1, 3200))
    return p


CASES = {
    "hybrid_labels_injected": (_hybrid, dict(conf_thres=0.25, iou_thres=0.5,
                                             max_det=10, top_k=16)),
    "labels_multi_label": (_with_labels, dict(conf_thres=0.1, iou_thres=0.6,
                                              multi_label=True, max_det=100,
                                              top_k=512)),
    "labels_single_class": (lambda r: _with_labels(r, nc=1),
                            dict(conf_thres=0.1, iou_thres=0.6, max_det=100,
                                 top_k=256)),
    "merge_redundant": (lambda r: _preds(r, 2, 200, 3),
                        dict(conf_thres=0.1, iou_thres=0.45, max_det=100,
                             top_k=256, merge=True)),
    "merge_keep_lone": (lambda r: _preds(r, 2, 200, 3),
                        dict(conf_thres=0.1, iou_thres=0.45, max_det=100,
                             top_k=256, merge=True, redundant=False)),
    "merge_tied_scores": (_tied, dict(conf_thres=0.25, iou_thres=0.3,
                                      max_det=100, top_k=128, merge=True)),
    "merge_one_candidate": (_one_candidate, dict(conf_thres=0.25,
                                                 iou_thres=0.45, max_det=10,
                                                 top_k=16, merge=True)),
    "merge_3000_candidates": (_many, dict(conf_thres=0.25, iou_thres=0.45,
                                          max_det=300, top_k=4096,
                                          merge=True)),
    "merge_with_labels": (_with_labels, dict(conf_thres=0.1, iou_thres=0.6,
                                             multi_label=True, max_det=100,
                                             top_k=512, merge=True)),
    "single_class": (lambda r: _preds(r, 2, 200, 1),
                     dict(conf_thres=0.1, iou_thres=0.5, max_det=200, top_k=256)),
    "tied_scores": (_tied, dict(conf_thres=0.25, iou_thres=0.3, max_det=100,
                                top_k=128)),
    "bf16_ties_multi_class": (_bf16_ties, dict(conf_thres=0.05, iou_thres=0.45,
                                               max_det=100, top_k=128)),
    "multi_class_best": (lambda r: _preds(r, 2, 150, 3),
                         dict(conf_thres=0.1, iou_thres=0.45, max_det=100,
                              top_k=128)),
    "multi_label": (lambda r: _preds(r, 2, 100, 3),
                    dict(conf_thres=0.1, iou_thres=0.45, multi_label=True,
                         max_det=100, top_k=256)),
    "agnostic": (lambda r: _preds(r, 2, 150, 3),
                 dict(conf_thres=0.1, iou_thres=0.45, agnostic=True,
                      max_det=100, top_k=128)),
    "class_mask": (lambda r: _preds(r, 2, 150, 4),
                   dict(conf_thres=0.05, iou_thres=0.45, max_det=100,
                        top_k=128, class_mask=[True, False, True, False])),
    "class_mask_multi_label": (lambda r: _preds(r, 1, 100, 4),
                               dict(conf_thres=0.05, iou_thres=0.45,
                                    multi_label=True, max_det=100, top_k=256,
                                    class_mask=[False, True, True, False])),
    "full_max_det": (_full, dict(conf_thres=0.25, iou_thres=0.45, max_det=50,
                                 top_k=128)),
    "empty_image": (lambda r: np.zeros((1, 32, 6), np.float32),
                    dict(conf_thres=0.25, iou_thres=0.45, max_det=20,
                         top_k=32)),
    "mixed_batch": (_mixed, dict(conf_thres=0.1, iou_thres=0.45, max_det=64,
                                 top_k=64)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_nms_identical_to_jax(name):
    make, kw = CASES[name]
    made = make(np.random.default_rng(len(name)))
    pred, labels, lmask = made if isinstance(made, tuple) else (made, None,
                                                                None)
    jkw, tkw = dict(kw), dict(kw)
    if "class_mask" in kw:
        jkw["class_mask"] = jnp.asarray(kw["class_mask"])
    if labels is not None:
        jkw.update(labels=jnp.asarray(labels), labels_mask=jnp.asarray(lmask))
        tkw.update(labels=torch.from_numpy(labels),
                   labels_mask=torch.from_numpy(lmask))
    want = jax_batched_nms(jnp.asarray(pred), **jkw)
    before = tracing.counters("nms.")
    got = batched_nms(torch.from_numpy(pred), **tkw)
    stats = {k[4:]: v - before.get(k, 0)
             for k, v in tracing.counters("nms.").items()}
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    if kw.get("merge"):
        np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                                   rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got.boxes.numpy(),
                                      np.asarray(want.boxes))
    # every iteration keeps one box in each image that still has candidates
    kept = int(got.valid.sum(1).max()) if not kw.get("merge") else None
    if kept is not None:
        assert kept <= stats["iterations"] <= min(kw["max_det"], kept + 8)
    if name == "full_max_det":
        assert got.valid.all()
    if name in ("empty_image", "mixed_batch"):
        assert not got.valid[0].any()
    if name == "hybrid_labels_injected":
        assert int(stats["candidates"]) == 2 and got.valid.sum() == 2
        np.testing.assert_array_equal(got.scores[got.valid].numpy(), 1.0)
    if name == "merge_one_candidate":  # a lone box is kept unmerged
        assert got.valid.sum() == 1
        np.testing.assert_array_equal(got.boxes[0, 0].numpy(),
                                      [80, 80, 120, 120])
    if name == "merge_3000_candidates":
        assert int(stats["candidates"]) >= 3000


def test_box_ops_match_jax():
    from multispectral_object_detection_tpu.ops import boxes as jboxes

    rng = np.random.default_rng(9)
    a = np.abs(rng.standard_normal((5, 4)).astype(np.float32)) * 50
    b = np.abs(rng.standard_normal((7, 4)).astype(np.float32)) * 50
    xa, xb = xywh_to_xyxy(torch.from_numpy(a)), xywh_to_xyxy(torch.from_numpy(b))
    ja, jb = jboxes.xywh_to_xyxy(jnp.asarray(a)), jboxes.xywh_to_xyxy(
        jnp.asarray(b))
    np.testing.assert_array_equal(xa.numpy(), np.asarray(ja))
    np.testing.assert_allclose(pairwise_iou(xa, xb).numpy(),
                               np.asarray(jax.jit(jboxes.pairwise_iou)(ja, jb)),
                               rtol=1e-6, atol=1e-7)
