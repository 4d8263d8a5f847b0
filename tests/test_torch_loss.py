"""PyTorch port, the detection loss against the JAX package: the
fixed-shape assigner (indices and masks equal, regression targets within
1e-6), the loss against the reference golden of tests/test_loss.py (1e-5
relative) and against JAX's ``DetectionLoss`` on random heads (1e-5) for
nc = 1 and nc = 3, with label smoothing and with the focal and quality
focal scales, and the blurred BCE. Both sides compute in fp32 on the same
inputs with the same formulas, so the bounds are a few fp32 ulps of sums
over a few hundred terms."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multispectral_object_detection_tpu.train.assigner import (
    assign_targets as jax_assign)
from multispectral_object_detection_tpu.train.loss import (
    DetectionLoss as JaxLoss)
from multispectral_object_detection_tpu.train.loss import LossHyp as JaxHyp
from multispectral_object_detection_tpu.train.loss import (
    bce_blur_with_logits as jax_bce_blur)
from multispectral_object_detection_tpu_torch.ops.boxes import iou
from multispectral_object_detection_tpu_torch.train.assigner import (
    assign_targets)
from multispectral_object_detection_tpu_torch.train.loss import (
    DetectionLoss, LossHyp, bce_blur_with_logits, scale_gains)
from tests._torch_port import share_torch_threads  # noqa: F401

ANCHORS = np.array(
    [[10, 13, 16, 30, 33, 23],
     [30, 61, 62, 45, 59, 119],
     [116, 90, 156, 198, 373, 326]], dtype=np.float32).reshape(3, 3, 2)
STRIDES = (8, 16, 32)
# the reference golden's targets (tests/test_loss.py), 7 over batch 2
TARGETS = np.array([
    [0, 0, 0.50, 0.50, 0.20, 0.30],
    [0, 1, 0.25, 0.75, 0.10, 0.10],
    [0, 2, 0.06, 0.06, 0.12, 0.12],
    [1, 0, 0.90, 0.10, 0.40, 0.20],
    [1, 1, 0.52, 0.48, 0.80, 0.60],
    [1, 2, 0.50, 0.03, 0.05, 0.05],
    [1, 0, 0.97, 0.97, 0.06, 0.09],
], dtype=np.float32)
GRIDS = ((8, 8), (4, 4), (2, 2))
REL = 1e-5


def _feats(nc, seed=42, B=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, ny, nx, 3, 5 + nc)).astype(np.float32)
            for ny, nx in GRIDS]


def _padded(seed=0, n_pad=9):
    """The golden targets, shuffled with masked padding rows between."""
    rng = np.random.default_rng(seed)
    t = np.concatenate([TARGETS, rng.uniform(0, 1, (n_pad, 6)).astype(
        np.float32)])
    m = np.concatenate([np.ones(len(TARGETS)), np.zeros(n_pad)]).astype(
        np.float32)
    order = rng.permutation(len(t))
    return t[order], m[order]


def test_assigner_matches_jax():
    t, m = _padded()
    anchors_grid = ANCHORS / np.asarray(STRIDES, np.float32).reshape(-1, 1, 1)
    got = assign_targets(torch.from_numpy(t), torch.from_numpy(m), GRIDS,
                         anchors_grid, 4.0)
    want = jax_assign(jnp.asarray(t), jnp.asarray(m), GRIDS, anchors_grid,
                      4.0)
    for g, w in zip(got, want):
        assert g.mask.sum() > 0
        for k in ("b", "a", "gj", "gi", "cls", "mask"):
            np.testing.assert_array_equal(getattr(g, k).numpy(),
                                          np.asarray(getattr(w, k)), err_msg=k)
        for k in ("txy", "twh"):
            np.testing.assert_allclose(getattr(g, k).numpy(),
                                       np.asarray(getattr(w, k)), atol=1e-6,
                                       rtol=0, err_msg=k)


def test_loss_matches_reference_golden():
    loss_fn = DetectionLoss(3, ANCHORS, STRIDES)
    total, comps = loss_fn([torch.from_numpy(f) for f in _feats(3)],
                           torch.from_numpy(TARGETS), torch.ones(7))
    golden = {"total": 11.45723724, "box": 0.13493280, "obj": 4.30005693,
              "cls": 1.29362893}
    for k, v in golden.items():
        assert abs(float(comps[k]) - v) <= REL * v, (k, float(comps[k]))
    assert float(total) == float(comps["total"])


@pytest.mark.parametrize("nc,smooth,gamma,qfl", [
    (1, 0.0, 0.0, False), (3, 0.0, 0.0, False), (3, 0.1, 0.0, False),
    (3, 0.0, 1.5, False), (3, 0.0, 1.5, True), (1, 0.0, 2.0, False)])
def test_loss_matches_jax_on_random_heads(nc, smooth, gamma, qfl):
    t, m = _padded(seed=nc)
    if nc == 1:
        t[:, 1] = 0
    feats = _feats(nc, seed=7 + nc)
    kw = dict(label_smoothing=smooth, fl_gamma=gamma, qfl=qfl)
    hyp = scale_gains(LossHyp(**kw), nc=nc, img_size=320, nl=3)
    jhyp = JaxHyp(**{k: getattr(hyp, k) for k in JaxHyp.__dataclass_fields__})
    got_t, got = DetectionLoss(nc, ANCHORS, STRIDES, hyp)(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(t),
        torch.from_numpy(m))
    want_t, want = JaxLoss(nc, ANCHORS, STRIDES, jhyp)(
        [jnp.asarray(f) for f in feats], jnp.asarray(t), jnp.asarray(m))
    for k in ("box", "obj", "cls", "total"):
        w = float(want[k])
        assert abs(float(got[k]) - w) <= REL * max(abs(w), 1e-6), k
    if nc == 1:
        assert float(got["cls"]) == 0.0


def test_loss_is_differentiable_and_ignores_padding():
    feats = [torch.from_numpy(f).requires_grad_() for f in _feats(3)]
    loss_fn = DetectionLoss(3, ANCHORS, STRIDES)
    t, m = _padded()
    total, _ = loss_fn(feats, torch.from_numpy(t), torch.from_numpy(m))
    ref, _ = loss_fn([f.detach() for f in feats], torch.from_numpy(TARGETS),
                     torch.ones(7))
    assert abs(float(total.detach()) - float(ref)) <= REL * float(ref)
    total.backward()
    assert all(f.grad is not None and torch.isfinite(f.grad).all()
               for f in feats)


def test_bce_blur_and_iou_kinds_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64,)).astype(np.float32)
    y = (rng.random(64) > 0.5).astype(np.float32)
    got = float(bce_blur_with_logits(torch.from_numpy(x), torch.from_numpy(y)))
    want = float(jax_bce_blur(jnp.asarray(x), jnp.asarray(y)))
    assert abs(got - want) <= REL * abs(want)
    from multispectral_object_detection_tpu.ops.boxes import iou as jax_iou

    b1 = np.abs(rng.normal(size=(32, 4))).astype(np.float32) + 0.1
    b2 = np.abs(rng.normal(size=(32, 4))).astype(np.float32) + 0.1
    for kind in ("iou", "giou", "diou", "ciou"):
        g = iou(torch.from_numpy(b1), torch.from_numpy(b2), xyxy=False,
                kind=kind).numpy()
        w = np.asarray(jax_iou(jnp.asarray(b1), jnp.asarray(b2), xyxy=False,
                               kind=kind))
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=kind)
