"""PyTorch port, greedy NMS's suppression (ops/nms._suppress) and its CUDA
kernel K3 ``nms_suppress`` (kernels/csrc/nms.cu).

On the CPU: the plain loop, K3's twin, keeps what the kernel's algorithm
keeps, written out here in numpy float32 with pairwise_iou's rounding (the
first alive candidate in ``_select``'s order, then every alive candidate
above the IoU threshold and the pick itself die, up to ``max_det`` picks);
``_select``'s alive scores never increase along K, which makes the first
alive candidate the greedy argmax; ``check_nms`` refuses what K3 does not
take. On the card (marked ``cuda``): K3 against the plain loop bit for bit
at eval shapes, with one launch and no host read per call. No JAX here:
the card tests run where there is none."""

import numpy as np
import pytest
import torch

from multispectral_object_detection_tpu_torch.ops import nms
from multispectral_object_detection_tpu_torch.utils import tracing
from tests._torch_port import share_torch_threads  # noqa: F401

_ALIVE = np.float32(-5e8)  # ops/nms: _NEG / 2


def _preds(rng, b, n, nc, hw=(512, 640), wh=(10, 120)):
    """Decoded (b, n, 5+nc): xywh in an (h, w) canvas, obj, class probs."""
    xy = rng.uniform(0, 1, (b, n, 2)) * np.array(hw[::-1])
    size = rng.uniform(*wh, (b, n, 2))
    obj = rng.uniform(0, 1, (b, n, 1))
    cls = rng.dirichlet(np.ones(nc), (b, n)) if nc > 1 else np.ones((b, n, 1))
    return np.concatenate([xy, size, obj, cls], -1).astype(np.float32)


def _tied(rng):
    """Clusters of overlapping boxes that all score exactly 0.5."""
    p = _preds(rng, 2, 96, 1, wh=(60, 80))
    p[..., 4] = 0.5
    p[..., :2] = np.round(p[..., :2] / 100) * 100 + rng.uniform(0, 5, (2, 96, 2))
    return p, {}


def _zero_area(rng):
    """Boxes of zero width or height, some of them on one spot: an IoU
    of 0 / eps, never above the threshold."""
    p = _preds(rng, 2, 80, 1, wh=(20, 60))
    p[:, ::3, 2] = 0.0
    p[:, 1::4, 3] = 0.0
    p[:, 40:48, :4] = [100, 100, 0, 0]
    return p, {}


def _nan_objectness(rng):
    """NaN objectness: the gate drops it, so it sorts among the zeros and
    reads ``_NEG``; NaN box coordinates on a confident row too (the IoU
    is NaN, above no threshold)."""
    p = _preds(rng, 2, 120, 2)
    p[:, ::5, 4] = np.nan
    p[0, 7, 0] = np.nan
    p[0, 7, 4] = 0.9
    return p, {}


def _hybrid(rng, nc=1):
    """Padded prior-label blocks (``--save-hybrid``), some rows masked out,
    overlapping the predictions and each other."""
    pred = _preds(rng, 2, 120, nc)
    labels = np.zeros((2, 10, 5), np.float32)
    labels[..., 0] = rng.integers(0, nc, (2, 10))
    labels[..., 1:3] = pred[:, :10, :2] + rng.uniform(-5, 5, (2, 10, 2))
    labels[..., 3:5] = rng.uniform(20, 100, (2, 10, 2))
    lmask = np.zeros((2, 10), np.float32)
    lmask[0, :7] = 1.0
    lmask[1, :3] = 1.0
    return pred, {"labels": torch.from_numpy(labels),
                  "labels_mask": torch.from_numpy(lmask)}


def _multi_label(rng):
    return _preds(rng, 2, 150, 3), {"multi_label": True}


def _few(rng):
    """Fewer candidates than max_det, and an image with none."""
    p = _preds(rng, 3, 64, 1)
    p[:, 12:, 4] = 0.0
    p[2, :, 4] = 0.0
    return p, {}


# name -> (inputs, conf, IoU threshold, max_det)
CASES = {
    "tied_scores": (_tied, 0.25, 0.3, 100),
    "zero_area_boxes": (_zero_area, 0.1, 0.45, 100),
    "nan_objectness": (_nan_objectness, 0.1, 0.45, 100),
    "save_hybrid_labels": (_hybrid, 0.1, 0.6, 100),
    "save_hybrid_labels_multi_label": (
        lambda r: (lambda p, kw: (p, {**kw, "multi_label": True}))(
            *_hybrid(r, nc=3)), 0.1, 0.6, 100),
    "multi_label_nc3": (_multi_label, 0.05, 0.45, 300),
    "max_det_0": (_multi_label, 0.05, 0.45, 0),
    "max_det_1": (_multi_label, 0.05, 0.45, 1),
    "fewer_than_max_det": (_few, 0.25, 0.45, 300),
    "eval_protocol": (lambda r: (_preds(r, 2, 600, 1), {}), 0.001, 0.6, 300),
}


def _case(name):
    make, conf, iou, max_det = CASES[name]
    pred, kw = make(np.random.default_rng(len(name)))
    _, shifted, scores, _ = nms._select(
        torch.from_numpy(pred), conf, None, kw.get("multi_label", False),
        False, 30000, None, kw.get("labels"), kw.get("labels_mask"))
    return shifted, scores, iou, max_det


def _iou_row(p, q):
    """pairwise_iou of one xyxy box with each row of q, in numpy float32,
    operation for operation (NaN passes through max, min and the clamp)."""
    iw = np.clip(np.minimum(p[2], q[:, 2]) - np.maximum(p[0], q[:, 0]), 0,
                 None)
    ih = np.clip(np.minimum(p[3], q[:, 3]) - np.maximum(p[1], q[:, 1]), 0,
                 None)
    inter = iw * ih
    area_p = (p[2] - p[0]) * (p[3] - p[1])
    area_q = (q[:, 2] - q[:, 0]) * (q[:, 3] - q[:, 1])
    return inter / (((area_p + area_q) - inter) + np.float32(1e-7))


def _greedy(shifted, scores, iou_thres, max_det):
    """K3's algorithm per image: kept indices, validity, picks per image
    and the candidates (0 when max_det is 0)."""
    B, K = scores.shape
    idxs = np.zeros((B, max_det), np.int64)
    vals = np.zeros((B, max_det), bool)
    picks = np.zeros(B, np.int64)
    candidates = 0
    thr = np.float32(iou_thres)
    for b in range(B):
        alive = scores[b] > _ALIVE
        candidates += int(alive.sum()) if max_det else 0
        while picks[b] < max_det and alive.any():
            i = int(np.flatnonzero(alive)[0])
            idxs[b, picks[b]], vals[b, picks[b]] = i, True
            picks[b] += 1
            alive &= ~(_iou_row(shifted[b, i], shifted[b]) > thr)
            alive[i] = False
    return idxs, vals, picks, candidates


def _scan(shifted, scores, iou_thres, max_det):
    """The same as K3 walks it: candidate j is kept when it is alive,
    fewer than max_det were kept before it and its IoU with each of those
    is at most the threshold (a pick kills only candidates after it)."""
    idxs = np.zeros((scores.shape[0], max_det), np.int64)
    for b in range(scores.shape[0]):
        kept = []
        for j in np.flatnonzero(scores[b] > _ALIVE):
            if len(kept) == max_det:
                break
            if not any(_iou_row(shifted[b, i], shifted[b, j:j + 1])[0]
                       > np.float32(iou_thres) for i in kept):
                kept.append(int(j))
        idxs[b, :len(kept)] = kept
    return idxs


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_loop_is_first_alive_then_suppress(name):
    shifted, scores, iou, max_det = _case(name)
    with np.errstate(invalid="ignore"):
        want_i, want_v, picks, cand = _greedy(shifted.numpy(), scores.numpy(),
                                              iou, max_det)
        np.testing.assert_array_equal(
            _scan(shifted.numpy(), scores.numpy(), iou, max_det), want_i)
    idxs, vals, it, candidates = nms._suppress(shifted, scores, iou, max_det)
    np.testing.assert_array_equal(idxs.numpy(), want_i)
    np.testing.assert_array_equal(vals.numpy(), want_v)
    assert candidates == cand
    assert picks.max(initial=0) <= it <= max_det
    if name == "fewer_than_max_det":
        assert 0 < picks.max() < max_det and picks[2] == 0
    if name in ("max_det_1", "multi_label_nc3", "eval_protocol"):
        assert picks.min() == max_det  # more survivors than slots


@pytest.mark.parametrize("name", sorted(CASES))
def test_select_alive_scores_never_increase(name):
    _, scores, _, _ = _case(name)
    assert scores.shape[1] > 0
    for row in scores:
        alive = row[row > float(_ALIVE)]
        assert not torch.isnan(row).any()
        assert (alive[1:] <= alive[:-1]).all()
        assert (alive > 0).all()


def test_plain_path_on_the_cpu_launches_no_kernel():
    shifted, scores, iou, max_det = _case("eval_protocol")
    before = tracing.counter(nms.COUNTER)
    with tracing.span("test") as root:
        nms._suppress(shifted, scores, iou, max_det)
    assert tracing.counter(nms.COUNTER) == before
    assert any(s.request == root.id and s.name == "sync.nms_exit"
               for s in tracing.spans())


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_batched_nms_on_an_empty_batch(device):
    """No image: empty outputs and zero counts on either path, and on the
    card no launch (there is nothing to suppress)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc to build the kernels")
    pred = torch.zeros((0, 50, 6), device=device)
    before = tracing.counter(nms.COUNTER)
    c0 = tracing.counters("nms.")
    out = nms.batched_nms(pred, conf_thres=0.001, max_det=300)
    assert tracing.counter(nms.COUNTER) == before
    after = tracing.counters("nms.")
    for k in ("nms.candidates", "nms.iterations"):
        assert after[k] == c0.get(k, 0)
    assert tuple(out.boxes.shape) == (0, 300, 4)
    assert tuple(out.valid.shape) == (0, 300)
    assert out.valid.device.type == device


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("B,K", [(32, 20160), (32, 30000), (1, 1), (2, 0),
                                 (1, nms.K3_MAX_K), (0, 64)])
def test_check_nms_takes_eval_shapes(B, K):
    nms.check_nms(_meta(B, K, 4), _meta(B, K), 300)
    nms.check_nms(_meta(B, K, 4), _meta(B, K), 9000)
    nms.check_nms(_meta(B, K, 4), _meta(B, K), nms.K3_MAX_DET)


@pytest.mark.parametrize("case", ["boxes_3", "scores_3d", "batch_mismatch",
                                  "float64", "bf16_boxes", "too_many",
                                  "max_det", "max_det_past_int32"])
def test_check_nms_refuses_what_the_kernel_does_not_take(case):
    boxes, scores, max_det = _meta(2, 64, 4), _meta(2, 64), 300
    if case == "boxes_3":
        boxes = _meta(2, 64, 3)
    elif case == "scores_3d":
        scores = _meta(2, 64, 1)
    elif case == "batch_mismatch":
        boxes = _meta(3, 64, 4)
    elif case == "float64":
        boxes, scores = (_meta(2, 64, 4, dtype=torch.float64),
                         _meta(2, 64, dtype=torch.float64))
    elif case == "bf16_boxes":
        boxes = _meta(2, 64, 4, dtype=torch.bfloat16)
    elif case == "too_many":
        K = nms.K3_MAX_K + 1
        boxes, scores = _meta(1, K, 4), _meta(1, K)
    elif case == "max_det":
        max_det = -1
    else:
        max_det = nms.K3_MAX_DET + 1
    with pytest.raises(ValueError, match="nms_suppress"):
        nms.check_nms(boxes, scores, max_det)


# ----------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc to build the kernels")
    return torch.device("cuda")


def _eval_inputs(B, K, device, seed=0):
    """``_select``'s outputs at the eval protocol (conf 0.001, multi-label,
    top_k 30000) with K candidates an image: K = 20,160 is one 640x512
    canvas's anchors at nc 1, K = 30,000 the top_k cut of nc 3.
    Objectness rounded as a bf16 head rounds it: many tied scores."""
    nc = 3 if K > 20160 else 1
    n = 20160 if K > 1 else 1
    p = _preds(np.random.default_rng(seed), B, n, nc)
    p[..., 4:] = torch.from_numpy(p[..., 4:]).bfloat16().float().numpy()
    _, shifted, scores, _ = nms._select(
        torch.from_numpy(p).to(device), 0.001, None, True, False, 30000,
        None, None, None)
    assert scores.shape == (B, K)
    return shifted, scores


@pytest.mark.cuda
@pytest.mark.parametrize("max_det", [0, 1, 300])
@pytest.mark.parametrize("K", [1, 20160, 30000])
@pytest.mark.parametrize("B", [1, 32])
def test_kernel_matches_plain_loop(cuda_device, B, K, max_det):
    shifted, scores = _eval_inputs(B, K, cuda_device)
    want_i, want_v, _, want_c = nms._suppress_plain(shifted, scores, 0.6,
                                                    max_det)
    before = tracing.counter(nms.COUNTER)
    idxs, vals, it, candidates = nms._suppress(shifted, scores, 0.6, max_det)
    torch.cuda.synchronize()
    assert tracing.counter(nms.COUNTER) - before == 1
    assert torch.equal(idxs, want_i) and torch.equal(vals, want_v)
    assert int(candidates) == want_c
    assert int(it) == int(want_v.sum(1).max())
    if max_det == 300 and K > 1:
        assert int(it) == 300


@pytest.mark.cuda
@pytest.mark.parametrize("max_det", [300, 2000])
def test_kernel_matches_plain_loop_on_clusters(cuda_device, max_det):
    """Boxes packed into 24 clusters an image: most candidates die, so the
    picks spread past the kernel's first tile of 1,024 candidates (to its
    last at max_det 2,000: about 550 picks an image), and room for 2,000
    kept boxes takes more than the default 48 KB of shared memory."""
    rng = np.random.default_rng(2)
    p = _preds(rng, 8, 20160, 1, wh=(30, 60))
    centres = rng.uniform(100, 500, (8, 24, 2))
    p[..., :2] = (centres[np.arange(8)[:, None], rng.integers(0, 24, (8, 20160))]
                  + rng.uniform(-12, 12, (8, 20160, 2)))
    _, shifted, scores, _ = nms._select(
        torch.from_numpy(p).to(cuda_device), 0.001, None, True, False,
        30000, None, None, None)
    want_i, want_v, _, want_c = nms._suppress_plain(shifted, scores, 0.6,
                                                    max_det)
    idxs, vals, it, candidates = nms._suppress(shifted, scores, 0.6, max_det)
    assert torch.equal(idxs, want_i) and torch.equal(vals, want_v)
    assert int(candidates) == want_c
    assert int(it) == int(want_v.sum(1).max())
    assert int(idxs[vals].max()) > 1024  # picks past the first tile


@pytest.mark.cuda
@pytest.mark.parametrize("max_det", [9000, 10000])
def test_kernel_matches_plain_loop_past_its_shared_memory_cache(cuda_device,
                                                                max_det):
    """More than the 8,192 kept boxes that K3 caches in shared memory: 9,500
    small boxes on a grid, one to a cell, and 2,500 near-copies of some of
    them (IoU about 0.75) spread through the score order, so that later
    tiles lose candidates to picks past the cache. At max_det 9,000 the
    picks stop at the cap; at 10,000 the walk ends with all 9,500 cells."""
    rng = np.random.default_rng(5)
    cells = 9500
    cx, cy = np.meshgrid(np.arange(100) * 6.4 + 3.2, np.arange(95) * 5.38
                         + 2.7)
    centre = np.stack([cx.ravel(), cy.ravel()], -1)
    which = np.concatenate([np.arange(cells), rng.integers(0, cells, 2500)])
    p = np.zeros((2, which.size, 6), np.float32)
    p[..., :2] = centre[which] + rng.uniform(-0.15, 0.15, (2, which.size, 2))
    p[..., 2:4] = 4.0
    p[..., 4] = rng.uniform(0.01, 1.0, (2, which.size))
    p[..., 5] = 1.0
    _, shifted, scores, _ = nms._select(
        torch.from_numpy(p).to(cuda_device), 0.001, None, True, False,
        30000, None, None, None)
    want_i, want_v, _, want_c = nms._suppress_plain(shifted, scores, 0.6,
                                                    max_det)
    before = tracing.counter(nms.COUNTER)
    idxs, vals, it, candidates = nms._suppress(shifted, scores, 0.6, max_det)
    assert tracing.counter(nms.COUNTER) - before == 1
    assert torch.equal(idxs, want_i) and torch.equal(vals, want_v)
    assert int(candidates) == want_c
    assert int(it) == min(max_det, cells)
    assert int(vals.sum(1).min()) == min(max_det, cells)


@pytest.mark.cuda
def test_counters_add_across_cards(cuda_device):
    """``batched_nms`` on one card and then on another in one process: the
    device-tensor counters add up across the cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    p = torch.from_numpy(_preds(np.random.default_rng(6), 4, 2000, 1))
    kw = dict(conf_thres=0.001, iou_thres=0.6, max_det=300)
    want = [nms.batched_nms(p, **kw) for _ in range(2)]
    c0 = tracing.counters("nms.")
    n = {}
    for card in (0, 1):
        dev = torch.device("cuda", card)
        before = tracing.counters("nms.")
        got = nms.batched_nms(p.to(dev), **kw)
        torch.cuda.synchronize(dev)
        n[card] = {k: v - before[k] for k, v in tracing.counters("nms.").items()}
        for g, w in zip(got, want[card]):
            assert g.device == dev and torch.equal(g.cpu(), w)
    assert n[0]["nms.candidates"] == n[1]["nms.candidates"] > 0
    assert n[0]["nms.iterations"] == n[1]["nms.iterations"] > 0
    total = tracing.counters("nms.")
    assert all(total[k] - c0[k] == n[0][k] + n[1][k] for k in n[0])


@pytest.mark.cuda
def test_batched_nms_on_cuda_is_one_launch_and_no_host_read(cuda_device):
    p = _preds(np.random.default_rng(1), 32, 20160, 1)
    pred = torch.from_numpy(p).to(cuda_device)
    kw = dict(conf_thres=0.001, iou_thres=0.6, multi_label=True,
              max_det=300, top_k=30000)
    want = nms.batched_nms(pred.cpu(), **kw)
    nms.batched_nms(pred, **kw)  # the library's first load
    torch.cuda.synchronize()
    before = tracing.counter(nms.COUNTER)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with tracing.span("test") as root:
            got = nms.batched_nms(pred, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tracing.counter(nms.COUNTER) - before == 1
    assert not any(s.request == root.id and s.name == "sync.nms_exit"
                   for s in tracing.spans())
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
