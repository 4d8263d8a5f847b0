"""PyTorch port, evaluation arithmetic against the JAX package: the metrics
(numpy in both: equal within 1e-9), the COCO-protocol evaluator (1e-9),
Dempster-Shafer fusion (torch fp32 against jnp fp32: 1e-6), and the
evaluator's result dict given one shared fake forward, so that both see the
same decoded predictions (metrics within 1e-9), with and without the
injected ground truth of ``--save-hybrid``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multispectral_object_detection_tpu.ops import ds_fusion as jds
from multispectral_object_detection_tpu.train.evaluator import (
    evaluate as jax_evaluate)
from multispectral_object_detection_tpu.utils import cocoeval as jcoco
from multispectral_object_detection_tpu.utils import metrics as jmetrics
from multispectral_object_detection_tpu_torch.ops import ds_fusion as tds
from multispectral_object_detection_tpu_torch.train.evaluator import evaluate
from multispectral_object_detection_tpu_torch.utils import cocoeval as tcoco
from multispectral_object_detection_tpu_torch.utils import metrics as tmetrics
from tests._torch_port import share_torch_threads  # noqa: F401

TOL = 1e-9       # numpy in both packages: the same operations
TOL_FP32 = 1e-6  # torch against jnp in fp32: sums in another order

# the JAX functions as one compiled program each (op by op is slower here)
_jdempster = jax.jit(jds.dempster_combine, static_argnames="return_conflict")
_jli, _jsun = jax.jit(jds.discount_li), jax.jit(jds.combine_sun)


def _assert_tree(got, want, tol=TOL):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree(got[k], want[k], tol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree(g, w, tol)
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64),
                                   rtol=tol, atol=tol)


def _metrics_inputs(seed=7, n=60, nc=3):
    rng = np.random.default_rng(seed)
    tp = (rng.uniform(size=(n, 10)) > np.linspace(0.3, 0.8, 10))
    tp = np.sort(tp, axis=1)[:, ::-1]
    conf = rng.uniform(0.05, 0.99, size=n)
    pred_cls = rng.integers(0, nc, size=n).astype(float)
    target_cls = np.repeat(np.arange(nc, dtype=float), 30)
    return tp, conf, pred_cls, target_cls


def _boxes(rng, n, scale=200.0):
    xy = rng.uniform(0, scale, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(5, 60, (n, 2))], 1)


@pytest.mark.parametrize("seed", [7, 11])
def test_ap_per_class_and_summary_match_jax(seed):
    tp, conf, pcls, tcls = _metrics_inputs(seed)
    _assert_tree(tmetrics.ap_per_class(tp, conf, pcls, tcls, curves=True),
                 jmetrics.ap_per_class(tp, conf, pcls, tcls, curves=True))
    stats = [(tp[:30], conf[:30], pcls[:30], list(tcls[:45])),
             (tp[30:], conf[30:], pcls[30:], list(tcls[45:]))]
    got, want = (m.summarize_stats(stats, nc=4, curves=True)
                 for m in (tmetrics, jmetrics))
    _assert_tree(got, want)
    assert tmetrics.fitness(0.5, 0.4, got["map50"], got["map"]) == \
        jmetrics.fitness(0.5, 0.4, want["map50"], want["map"])
    n_gt = len(tcls)
    assert tmetrics.log_average_miss_rate(tp[:, 0], conf, 9, n_gt) == \
        jmetrics.log_average_miss_rate(tp[:, 0], conf, 9, n_gt)


def test_summary_edge_cases_match_jax():
    empty = [(np.zeros((0, 10), bool), np.zeros(0), np.zeros(0), [0.0, 1.0])]
    for stats in ([], empty):
        _assert_tree(tmetrics.summarize_stats(stats, nc=2),
                     jmetrics.summarize_stats(stats, nc=2))
    for rec, prec in ((np.array([0.5, 1.0]), np.array([1.0, 1.0])),
                      (np.array([0.1, 0.2, 0.2]), np.array([1.0, 0.5, 0.3]))):
        assert tmetrics.compute_ap(rec, prec) == jmetrics.compute_ap(rec, prec)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_predictions_and_confusion_match_jax(seed):
    rng = np.random.default_rng(seed)
    tb = _boxes(rng, 12)
    tc = rng.integers(0, 3, 12).astype(float)
    # predictions near the targets (some duplicates, some wrong class)
    pb = np.concatenate([tb + rng.normal(0, 4, tb.shape), _boxes(rng, 8)])
    pc = np.concatenate([tc, rng.integers(0, 3, 8).astype(float)])
    pc[rng.uniform(size=20) < 0.2] = 2
    ps = rng.uniform(0.1, 1.0, 20)
    order = np.argsort(-ps)
    pb, pc, ps = pb[order], pc[order], ps[order]
    np.testing.assert_array_equal(
        tmetrics.match_predictions(pb, pc, tb, tc),
        jmetrics.match_predictions(pb, pc, tb, tc))
    cm_t, cm_j = tmetrics.ConfusionMatrix(3), jmetrics.ConfusionMatrix(3)
    for cm in (cm_t, cm_j):
        cm.process_batch(pb, ps, pc, tb, tc)
        cm.process_batch(pb[:0], ps[:0], pc[:0], tb, tc)
    np.testing.assert_array_equal(cm_t.matrix, cm_j.matrix)


def _coco_cases():
    cases = {
        "perfect": ([{"image_id": 1, "category_id": 0,
                      "bbox": [10, 10, 20, 20]}],
                    [{"image_id": 1, "category_id": 0,
                      "bbox": [10, 10, 20, 20], "score": 0.9}]),
        "iou_two_thirds": ([{"image_id": 1, "category_id": 0,
                             "bbox": [0, 0, 10, 30]}],
                           [{"image_id": 1, "category_id": 0,
                             "bbox": [0, 0, 10, 20], "score": 0.9}]),
        "fp_first": ([{"image_id": 1, "category_id": 0, "bbox": [0, 0, 10, 10]}],
                     [{"image_id": 1, "category_id": 0,
                       "bbox": [50, 50, 10, 10], "score": 0.95},
                      {"image_id": 1, "category_id": 0,
                       "bbox": [0, 0, 10, 10], "score": 0.6}]),
        "unseen_category": ([{"image_id": 1, "category_id": 0,
                              "bbox": [0, 0, 10, 10]},
                             {"image_id": 1, "category_id": 3,
                              "bbox": [30, 30, 5, 5]}],
                            [{"image_id": 1, "category_id": 0,
                              "bbox": [0, 0, 10, 10], "score": 0.9}]),
        "gt_matched_once": ([{"image_id": 1, "category_id": 0,
                              "bbox": [0, 0, 10, 10]}],
                            [{"image_id": 1, "category_id": 0,
                              "bbox": [0, 0, 10, 10], "score": 0.9},
                             {"image_id": 1, "category_id": 0,
                              "bbox": [1, 0, 10, 10], "score": 0.8}]),
    }
    rng = np.random.default_rng(3)
    gt, det = [], []
    for img in range(6):
        b = _boxes(rng, 5)
        for k in range(5):
            box = [float(b[k, 0]), float(b[k, 1]), float(b[k, 2] - b[k, 0]),
                   float(b[k, 3] - b[k, 1])]
            cat = int(rng.integers(0, 2))
            gt.append({"image_id": img, "category_id": cat, "bbox": box})
            for _ in range(int(rng.integers(0, 3))):
                jit = list(np.asarray(box) + rng.normal(0, 3, 4))
                det.append({"image_id": img, "category_id": cat, "bbox": jit,
                            "score": float(rng.uniform())})
    cases["random_images"] = (gt, det)
    return cases


@pytest.mark.parametrize("name", sorted(_coco_cases()))
def test_coco_eval_matches_jax(name):
    gt, det = _coco_cases()[name]
    _assert_tree(tcoco.coco_eval_bbox(gt, det), jcoco.coco_eval_bbox(gt, det))


@pytest.mark.parametrize("e,k,seed", [(2, 2, 0), (3, 4, 1), (5, 3, 2)])
def test_dempster_li_sun_match_jax(e, k, seed):
    rng = np.random.RandomState(seed)
    m = rng.rand(e, 4, 7, k + 1).astype(np.float32)
    m /= m.sum(axis=-1, keepdims=True)
    tm, jm = torch.from_numpy(m), jnp.asarray(m)
    fused, conflict = tds.dempster_combine(tm, return_conflict=True)
    jf, jc = _jdempster(jm, return_conflict=True)
    _assert_tree((fused, conflict), (jf, jc), TOL_FP32)
    sing = m[..., :-1]
    _assert_tree(tds.discount_li(torch.from_numpy(sing)),
                 _jli(jnp.asarray(sing)), TOL_FP32)
    _assert_tree(tds.combine_sun(torch.from_numpy(sing)),
                 _jsun(jnp.asarray(sing)), TOL_FP32)
    certain = np.eye(k + 1, dtype=np.float32)[:2]  # total conflict: no NaN
    _assert_tree(tds.dempster_combine(torch.from_numpy(certain),
                                      return_conflict=True),
                 _jdempster(jnp.asarray(certain), return_conflict=True),
                 TOL_FP32)


@pytest.mark.parametrize("method", ["plain", "li", "sun"])
def test_fuse_detections_matches_jax(method):
    rng = np.random.RandomState(4)
    dets = rng.rand(3, 2, 8, 5 + 4).astype(np.float32)
    dets[..., :4] *= 100
    dets[0, 0, 0, 4] = 0.0  # one member sees nothing at one anchor
    got = tds.fuse_detections(torch.from_numpy(dets), method=method)
    want = jds.fuse_detections_jit(jnp.asarray(dets), method=method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_FP32,
                               atol=TOL_FP32 * 100)  # boxes up to 100 px
    with pytest.raises(ValueError):
        tds.fuse_detections(torch.from_numpy(dets), method="bogus")


# ---------------------------------------------------------------------------
# the evaluator, over fake batches and a fake forward shared by both
# ---------------------------------------------------------------------------

B, H, W, NC, ML = 3, 96, 128, 2, 8


def _fake_batches(seed=0, n_batches=2):
    """Batches in the collate layout, letterboxed from 80x120 natives,
    with decoded predictions near the ground truth (and noise)."""
    rng = np.random.default_rng(seed)
    batches, preds = [], []
    ratio, pad = 1.0, (4.0, 8.0)
    for _ in range(n_batches):
        targets = np.zeros((B * ML, 6), np.float32)
        tmask = np.zeros((B * ML,), np.float32)
        pred = np.zeros((B, 200, 5 + NC), np.float32)
        for b in range(B):
            n = int(rng.integers(1, ML))
            rows = slice(b * ML, b * ML + n)
            xy = rng.uniform(0.2, 0.8, (n, 2))
            wh = rng.uniform(0.1, 0.3, (n, 2))
            targets[rows, 0] = b
            targets[rows, 1] = rng.integers(0, NC, n)
            targets[rows, 2:4] = xy
            targets[rows, 4:6] = wh
            tmask[rows] = 1.0
            gt_px = np.concatenate([xy, wh], 1) * [W, H, W, H]
            k = np.arange(200) % n
            pred[b, :, :4] = gt_px[k] + rng.normal(0, 3, (200, 4))
            pred[b, :, 4] = rng.uniform(0, 1, 200)
            cls = rng.dirichlet(np.ones(NC), 200)
            cls[np.arange(200), targets[rows, 1][k].astype(int)] += 1.0
            pred[b, :, 5:] = cls / cls.sum(1, keepdims=True)
        shapes = [((80, 120), ((ratio, ratio), pad))] * B
        rgb = np.zeros((B, H, W, 3), np.uint8)
        batches.append({"rgb": rgb, "ir": rgb, "targets": targets,
                        "tmask": tmask, "shapes": shapes})
        preds.append(pred)
    return batches, preds


@pytest.mark.parametrize("hybrid,single_cls", [(False, False), (True, False),
                                               (False, True)])
def test_evaluator_matches_jax_on_one_fake_forward(hybrid, single_cls):
    batches, preds = _fake_batches()
    nc = 1 if single_cls else NC
    calls = {"jax": 0, "torch": 0}

    def jax_fwd(params, stats, rgb, ir):
        calls["jax"] += 1
        return jnp.asarray(preds[calls["jax"] - 1]), None

    def torch_fwd(rgb, ir):
        assert rgb.dtype == torch.uint8 and rgb.shape == (B, H, W, 3)
        calls["torch"] += 1
        return torch.from_numpy(preds[calls["torch"] - 1]), None

    seen = {"jax": [], "torch": []}
    kw = dict(nc=nc, hybrid=hybrid, single_cls=single_cls, conf_thres=0.01)
    want = jax_evaluate(jax_fwd, None, None, batches,
                        per_image=lambda *a: seen["jax"].append(a), **kw)
    got = evaluate(torch_fwd, batches, device="cpu",
                   per_image=lambda *a: seen["torch"].append(a), **kw)
    for k in ("t_infer_ms", "t_nms_ms"):
        assert got.pop(k) >= 0 and want.pop(k) >= 0
    extra = {k: got.pop(k) for k in ("t_match_ms", "nms_candidates",
                                     "nms_iterations")}
    assert extra["nms_candidates"] > 0 and extra["nms_iterations"] > 0
    _assert_tree(got, want)
    assert got["seen"] == 2 * B and got["map50"] > 0.1
    if hybrid:  # the injected ground truth matches itself
        assert got["map50"] > 0.99
    for g, w in zip(seen["torch"], seen["jax"]):
        _assert_tree(g, w, 1e-4)  # boxes from fp32 NMS rescaled in numpy
