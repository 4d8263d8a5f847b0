"""PyTorch port, the ``--device-aug`` path on the CPU against the JAX
package: ``hsv_jitter_batch`` (ops/preprocess.py) and
``device_mosaic_batch`` (ops/augment_device.py) with the factors and draws
that JAX's key gives, reproduced from the key on the test side; the
mosaic's label/image consistency and flip checks of
tests/test_augment_device.py on the port; and the host batches of the path
(``get_tile``/``collate_tiles``) and of ``--quad`` (``collate_quad``)
against the JAX loader's under the same ``random.Random``."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multispectral_object_detection_tpu.data import datasets as jds
from multispectral_object_detection_tpu.ops.augment_device import (
    device_mosaic_batch as jax_mosaic)
from multispectral_object_detection_tpu.ops.preprocess import (
    hsv_jitter_batch as jax_hsv)
from multispectral_object_detection_tpu_torch.data import datasets as tds
from multispectral_object_detection_tpu_torch.data.synthetic import (
    make_paired_dataset)
from multispectral_object_detection_tpu_torch.ops.augment_device import (
    device_mosaic_batch, draw_mosaic, image_targets, take_rows)
from multispectral_object_detection_tpu_torch.ops.preprocess import (
    draw_hsv_factors, hsv_jitter_batch)
from tests._torch_port import share_torch_threads  # noqa: F401

GAINS = (0.015, 0.7, 0.4)


def jax_draws(key, B, s, scale=0.5, translate=0.1, fliplr=0.5,
              gains=GAINS):
    """The draws of JAX's ``device_mosaic_batch(key=key)``: keys
    split(key, B + 3); per sample split(k, 4) -> randint yc, randint xc,
    uniform r, uniform tshift (2,); bernoulli(keys[B]) flips;
    keys[B + 1] and keys[B + 2] the HSV factors of RGB and IR."""
    keys = jax.random.split(key, B + 3)
    yc, xc, r, ts = [], [], [], []
    for b in range(B):
        k1, k2, k3, k4 = jax.random.split(keys[b], 4)
        yc.append(int(jax.random.randint(k1, (), s // 2, 2 * s - s // 2)))
        xc.append(int(jax.random.randint(k2, (), s // 2, 2 * s - s // 2)))
        r.append(float(jax.random.uniform(k3, (), minval=1.0 - scale,
                                          maxval=1.0 + scale)))
        ts.append(np.asarray(jax.random.uniform(
            k4, (2,), minval=0.5 - translate, maxval=0.5 + translate) * s))
    g = jnp.asarray(gains)

    def hsv(k):
        return torch.from_numpy(np.array(jax.random.uniform(
            k, (B, 3), minval=-1.0, maxval=1.0) * g + 1.0))

    return {"yc": torch.tensor(yc), "xc": torch.tensor(xc),
            "r": torch.tensor(r, dtype=torch.float32),
            "tshift": torch.from_numpy(np.stack(ts)),
            "flip": torch.from_numpy(np.array(jax.random.bernoulli(
                keys[B], fliplr, (B,)))),
            "hsv_rgb": hsv(keys[B + 1]), "hsv_ir": hsv(keys[B + 2])}


def _levels(a, b):
    return np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))


@pytest.mark.parametrize("seed", [0, 1])
def test_hsv_jitter_matches_jax(seed):
    """uint8 within 1 level at >= 99.99 % of pixels; a pixel further off is
    a hue-sector flip (floor(h * 6) on the other side of an integer in
    fp32), counted and allowed at that share."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (4, 96, 96, 3), dtype=np.uint8)
    x[0, :8] = 128  # gray: hue 0, saturation 0
    x[1, :8, :, 0] = 255  # sector edges
    key = jax.random.PRNGKey(seed)
    gains = jnp.asarray([0.5, 0.7, 0.4])
    want = np.asarray(jax_hsv(jnp.asarray(x), gains, key))
    f = np.array(jax.random.uniform(key, (4, 3), minval=-1.0, maxval=1.0)
                 * gains + 1.0)
    got = hsv_jitter_batch(torch.from_numpy(x), torch.from_numpy(f)).numpy()
    assert got.dtype == np.uint8 and got.shape == x.shape
    d = _levels(got, want)
    flips = (d > 1).any(-1).mean()
    print(f"within 1 level {np.mean(d <= 1):.6f}, sector flips {flips:.2e}")
    assert np.mean(d <= 1) >= 0.9999 and flips <= 1e-4


def test_hsv_factors_and_unit_factors():
    g = torch.Generator().manual_seed(0)
    f = draw_hsv_factors(g, 64, (0.1, 0.2, 0.3))
    assert f.shape == (64, 3)
    assert ((f - 1).abs() <= torch.tensor([0.1, 0.2, 0.3])).all()
    x = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (2, 32, 32, 3), dtype=np.uint8))
    d = _levels(hsv_jitter_batch(x, torch.ones(2, 3)), x)
    assert d.max() <= 1  # the round trip through HSV keeps the pixels


def _tiles(B, s, M, seed):
    rng = np.random.default_rng(seed)
    tr = rng.integers(0, 256, (B, 4, s, s, 3), dtype=np.uint8)
    ti = rng.integers(0, 256, (B, 4, s, s, 3), dtype=np.uint8)
    lab = np.zeros((B, 4, M, 5), np.float32)
    lab[..., 0] = rng.integers(0, 3, (B, 4, M))
    lab[..., 1:3] = rng.uniform(0.2, 0.8, (B, 4, M, 2))
    lab[..., 3:5] = rng.uniform(0.05, 0.4, (B, 4, M, 2))
    lm = (rng.random((B, 4, M)) < 0.7).astype(np.float32)
    return tr, ti, lab, lm


@pytest.mark.parametrize("seed,hyp", [
    (0, {}), (1, dict(scale=0.9, translate=0.2, fliplr=1.0)),
    (2, dict(scale=0.0, translate=0.0, fliplr=0.0))])
def test_device_mosaic_matches_jax(seed, hyp):
    """Images within 1 level at >= 99.9 % of pixels (the resampling
    products accumulate in another order), targets within 1e-4, masks
    equal."""
    B, s, M = 3, 64, 5
    tr, ti, lab, lm = _tiles(B, s, M, seed)
    key = jax.random.PRNGKey(seed + 10)
    kw = dict(scale_jit=hyp.get("scale", 0.5),
              translate=hyp.get("translate", 0.1),
              fliplr=hyp.get("fliplr", 0.5))
    want = jax_mosaic(jnp.asarray(tr), jnp.asarray(ti), jnp.asarray(lab),
                      jnp.asarray(lm), key, img_size=s, **kw)
    draws = jax_draws(key, B, s, kw["scale_jit"], kw["translate"],
                      kw["fliplr"])
    got = device_mosaic_batch(torch.from_numpy(tr), torch.from_numpy(ti),
                              torch.from_numpy(lab), torch.from_numpy(lm),
                              draws, s)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == torch.uint8 and g.shape == (B, s, s, 3)
        assert np.mean(_levels(g.numpy(), w) <= 1) >= 0.999
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    m = np.asarray(want[3]) > 0
    assert m.sum() > 0
    np.testing.assert_allclose(got[2].numpy()[m], np.asarray(want[2])[m],
                               atol=1e-4)


def _tile_with_box(s, box, val=250):
    img = np.full((s, s, 3), 30, np.uint8)
    cx, cy, w, h = box
    img[int((cy - h / 2) * s):int((cy + h / 2) * s),
        int((cx - w / 2) * s):int((cx + w / 2) * s)] = val
    return img


def _box_batch(B, s, rng):
    tiles = np.zeros((B, 4, s, s, 3), np.uint8)
    labels = np.zeros((B, 4, 2, 5), np.float32)
    lmask = np.zeros((B, 4, 2), np.float32)
    for b in range(B):
        for t in range(4):
            box = [rng.uniform(0.3, 0.7), rng.uniform(0.3, 0.7),
                   rng.uniform(0.15, 0.3), rng.uniform(0.15, 0.3)]
            tiles[b, t] = _tile_with_box(s, box)
            labels[b, t, 0] = [0] + box
            lmask[b, t, 0] = 1.0
    return tuple(torch.from_numpy(a) for a in (tiles, labels, lmask))


def test_device_mosaic_label_image_consistency():
    s = 96
    tiles, labels, lmask = _box_batch(2, s, np.random.default_rng(0))
    draws = draw_mosaic(torch.Generator().manual_seed(3), 2, s, dict(
        scale=0.3, translate=0.1, fliplr=0.0, hsv_h=0, hsv_s=0, hsv_v=0))
    rgb, _, targets, mask = (t.numpy() for t in device_mosaic_batch(
        tiles, tiles, labels, lmask, draws, s))
    assert rgb.shape == (2, s, s, 3) and mask.sum() >= 2
    for b in range(2):
        cover = np.zeros((s, s), bool)
        for t, m in zip(targets[b], mask[b]):
            if m == 0:
                continue
            cx, cy, w, h = t[1:] * s
            x1, y1 = max(int(cx - w / 2), 0), max(int(cy - h / 2), 0)
            x2, y2 = min(int(cx + w / 2), s), min(int(cy + h / 2), s)
            assert x2 > x1 and y2 > y1
            inner = rgb[b, y1 + 2:y2 - 2, x1 + 2:x2 - 2, 0]
            if inner.size:  # the labelled region is the bright object
                assert inner.mean() > 150, (b, t, inner.mean())
            cover[max(y1 - 2, 0):y2 + 2, max(x1 - 2, 0):x2 + 2] = True
        stray = (rgb[b, :, :, 0] > 150) & ~cover
        assert stray.mean() < 0.02, stray.mean()


def test_device_mosaic_flip_consistency():
    s = 64
    tiles, labels, lmask = _box_batch(1, s, np.random.default_rng(1))
    draws = draw_mosaic(torch.Generator().manual_seed(0), 1, s, dict(
        scale=0.0, translate=0.0, fliplr=1.0, hsv_h=0, hsv_s=0, hsv_v=0))
    assert bool(draws["flip"][0])
    rgb, _, targets, mask = (t.numpy() for t in device_mosaic_batch(
        tiles, tiles, labels, lmask, draws, s))
    checked = 0
    for t, m in zip(targets[0], mask[0]):
        cx, cy, w, h = t[1:] * s
        x1, y1 = int(cx - w / 2) + 2, int(cy - h / 2) + 2
        x2, y2 = int(cx + w / 2) - 2, int(cy + h / 2) - 2
        if m and x2 > x1 and y2 > y1:
            assert rgb[0, y1:y2, x1:x2, 0].mean() > 150
            checked += 1
    assert checked


def test_draws_rows_and_image_targets():
    g = torch.Generator().manual_seed(5)
    d = draw_mosaic(g, 8, 64, {})
    assert ((d["yc"] >= 32) & (d["yc"] < 96)).all()
    assert ((d["r"] >= 0.5) & (d["r"] <= 1.5)).all()
    part = take_rows(d, 2, 6)
    assert all(v.shape[0] == 4 for v in part.values())
    assert torch.equal(part["tshift"], d["tshift"][2:6])
    t, m = image_targets(torch.ones(3, 4, 5), torch.ones(3, 4))
    assert t.shape == (12, 6) and m.shape == (12,)
    assert t[:, 0].tolist() == [0.0] * 4 + [1.0] * 4 + [2.0] * 4


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    root = tmp_path_factory.mktemp("augdev")
    # a non-square native size, so get_tile letterboxes and scales up
    return make_paired_dataset(str(root / "d"), n_images=8, img_size=80,
                               nc=2, seed=4, img_hw=(48, 80))


def _datasets(pairs, s=96):
    kw = dict(img_size=s, augment=True, nc=2)
    return (tds.PairedDetectionDataset.from_sources(*pairs, **kw),
            jds.PairedDetectionDataset.from_sources(*pairs, **kw))


def test_tile_batches_equal_the_jax_loader(pairs):
    """Partners drawn from the loader's random.Random: tiles bit-equal
    (both letterbox through cv2's resize; the port's C++ runtime
    reproduces its pixels), labels and masks equal."""
    pt, jt = _datasets(pairs)
    got = tds.collate_tiles(pt, [3, 0, 5], random.Random(7), 6)
    want = jds.collate_tiles(jt, [3, 0, 5], random.Random(7), 6)
    for k in ("tiles_rgb", "tiles_ir", "tile_lmask"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["tile_labels"], want["tile_labels"],
                               atol=1e-6)
    r, q, lab = pt.get_tile(2)
    assert r.shape == q.shape == (96, 96, 3) and lab.shape[1] == 5
    pl = tds.BatchLoader(pt, 4, shuffle=True, seed=3, drop_last=True,
                         device_aug=True, max_labels_per_tile=6)
    jl = jds.BatchLoader(jt, 4, shuffle=True, seed=3, device_aug=True,
                         max_labels_per_tile=6, prefetch=False)
    for a, b in zip(pl, jl):
        np.testing.assert_array_equal(a["tiles_rgb"], b["tiles_rgb"])
        np.testing.assert_allclose(a["tile_labels"], b["tile_labels"],
                                   atol=1e-6)


def test_quad_batches_match_the_jax_loader(pairs):
    """Augmented samples, then ``collate_quad`` under the same generators:
    the stitched canvases bit-equal, the 2x upsamples within 1 level (the
    JAX package resizes through native/image_ops.cpp, the port through its
    cv2-exact runtime), targets and masks equal."""
    pt, jt = _datasets(pairs, s=64)
    pl = tds.BatchLoader(pt, 8, shuffle=True, seed=1, drop_last=True,
                         quad=True, max_labels=20)
    jl = jds.BatchLoader(jt, 8, shuffle=True, seed=1, quad=True,
                         max_labels=20, prefetch=False)
    n = 0
    for a, b in zip(pl, jl):
        assert a["rgb"].shape == b["rgb"].shape == (2, 128, 128, 3)
        for k in ("rgb", "ir"):
            assert _levels(a[k], b[k]).max() <= 1, k
        np.testing.assert_allclose(a["targets"], b["targets"], atol=1e-5)
        np.testing.assert_array_equal(a["tmask"], b["tmask"])
        n += 1
    assert n == 1
    # both branches: stitched (bit-equal) and upsampled
    samples = [pt.get(i, random.Random(i)) for i in range(8)]
    jsamples = [jt.get(i, random.Random(i)) for i in range(8)]
    equal = 0
    for seed in range(6):
        a = tds.collate_quad(samples, list(range(8)), 20, random.Random(seed))
        b = jds.collate_quad(jsamples, 20, random.Random(seed))
        d = _levels(a["rgb"], b["rgb"])
        assert d.max() <= 1
        equal += int(sum(d[g].max() == 0 for g in range(2)))
        np.testing.assert_allclose(a["targets"], b["targets"], atol=1e-6)
    assert equal  # the stitched canvases
    with pytest.raises(ValueError, match="divisible by 4"):
        tds.collate_quad(samples[:6], list(range(6)))
    with pytest.raises(ValueError, match="exclusive"):
        tds.BatchLoader(pt, 8, quad=True, device_aug=True)


def test_rank_rows_of_a_loader(pairs):
    """Under data parallelism the ranks' rows make up the one-process
    batch order; rank 0 draws as one process does."""
    pt, _ = _datasets(pairs, s=64)
    one = tds.BatchLoader(pt, 4, shuffle=True, seed=2, drop_last=True)
    ranks = [tds.BatchLoader(pt, 4, shuffle=True, seed=2, drop_last=True,
                             rank=r, world=2) for r in range(2)]
    for k, (a, b0, b1) in enumerate(zip(one, *ranks)):
        assert np.concatenate([b0["index"], b1["index"]]).tolist() == \
            a["index"].tolist()
        if k == 0:  # then rank 0's generator has drawn for 2 of 4 rows
            np.testing.assert_array_equal(b0["rgb"], a["rgb"][:2])
    with pytest.raises(ValueError, match="does not split"):
        tds.BatchLoader(pt, 5, world=2)
