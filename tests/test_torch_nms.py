"""PyTorch port, batched NMS: kept detections identical to the JAX
package's batched_nms on the same decoded predictions, including tied
scores, where the order of the top-k decides which box survives."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multispectral_object_detection_tpu.ops.nms import (
    batched_nms as jax_batched_nms)
from multispectral_object_detection_tpu_torch.ops.boxes import (
    pairwise_iou, xywh_to_xyxy)
from multispectral_object_detection_tpu_torch.ops.nms import batched_nms


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


CASES = {
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
    pred = make(np.random.default_rng(len(name)))
    jkw = dict(kw)
    if "class_mask" in kw:
        jkw["class_mask"] = jnp.asarray(kw["class_mask"])
    want = jax_batched_nms(jnp.asarray(pred), **jkw)
    got = batched_nms(torch.from_numpy(pred), **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))
    if name == "full_max_det":
        assert got.valid.all()
    if name in ("empty_image", "mixed_batch"):
        assert not got.valid[0].any()


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
                               np.asarray(jboxes.pairwise_iou(ja, jb)),
                               rtol=1e-6, atol=1e-7)
