"""PyTorch port, the host augmentations that no training path calls
(data/augment.py: ``mosaic9_pair``, ``cutout``, ``replicate``,
``hist_equalize``) against the JAX package's under the same seeds, and the
checks of tests/test_augment_extras.py on the port. Warps run through cv2
here, as the JAX package's do, so the outputs are equal; ``hist_equalize``
names cv2 where it is missing (the card)."""

import random

import numpy as np
import pytest

from multispectral_object_detection_tpu.data import augment as jaug
from multispectral_object_detection_tpu_torch.data import augment as taug
from tests._torch_port import share_torch_threads  # noqa: F401


def _img(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (h, w, 3),
                                                dtype=np.uint8)


def _load(i):
    img = _img(40 + 4 * (i % 3), 56 - 2 * (i % 4), seed=i)
    lab = np.asarray([[i % 2, 0.5, 0.5, 0.4, 0.4],
                      [1, 0.3, 0.6, 0.2, 0.3]], np.float32)
    segs = [np.asarray([[0.3, 0.3], [0.7, 0.3], [0.7, 0.7], [0.3, 0.7]],
                       np.float32), np.asarray([[0.2, 0.45], [0.4, 0.45],
                                                [0.4, 0.75]], np.float32)]
    return img, img // 2, lab, segs


@pytest.mark.parametrize("seed,hyp", [
    (3, {"translate": 0.1, "scale": 0.5}),
    (4, {"translate": 0.2, "scale": 0.3, "degrees": 10.0, "shear": 2.0})])
def test_mosaic9_pair_matches_jax(seed, hyp):
    s = 64
    got = taug.mosaic9_pair(_load, list(range(9)), s, hyp,
                            random.Random(seed))
    want = jaug.mosaic9_pair(_load, list(range(9)), s, hyp,
                             random.Random(seed))
    assert got[0].shape == got[1].shape == (s, s, 3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], atol=1e-4)
    assert got[2].ndim == 2 and got[2].shape[1] == 5
    if len(got[2]):
        assert got[2][:, 1:].min() >= 0 and got[2][:, 1:].max() <= s
    # the modalities share the geometry: IR was RGB // 2 tile for tile
    nz = got[0][:, :, 0] > 0
    assert np.array_equal(got[1][nz] > 0, (got[0] // 2)[nz] > 0)


@pytest.mark.parametrize("seed", range(4))
def test_cutout_matches_jax(seed):
    labels = np.asarray([[0, 5, 5, 60, 60], [1, 10, 10, 14, 14],
                         [0, 30, 20, 50, 40]], np.float32)
    a, b = _img(64, 64, seed), _img(64, 64, seed)
    got = taug.cutout(a, labels.copy(), random.Random(seed))
    want = jaug.cutout(b, labels.copy(), random.Random(seed))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got, want)


def test_cutout_drops_obscured():
    dropped = False
    for seed in range(30):
        lab = np.asarray([[0, 10, 10, 14, 14]], np.float32)
        if len(taug.cutout(_img(64, 64), lab, random.Random(seed))) == 0:
            dropped = True
            break
    assert dropped


@pytest.mark.parametrize("seed", range(3))
def test_replicate_matches_jax(seed):
    labels = np.asarray([[0, 2, 2, 10, 10], [1, 20, 20, 50, 50],
                         [0, 30, 5, 38, 16], [1, 1, 40, 60, 63]], np.float32)
    got = taug.replicate(_img(64, 64, seed), labels.copy(),
                         random.Random(seed))
    want = jaug.replicate(_img(64, 64, seed), labels.copy(),
                          random.Random(seed))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert len(got[1]) == 6  # the smaller half (2 of 4) replicated


@pytest.mark.parametrize("clahe", [True, False])
def test_hist_equalize_matches_jax(clahe):
    im = _img(32, 48)
    got = taug.hist_equalize(im.copy(), clahe=clahe)
    assert got.shape == im.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jaug.hist_equalize(im.copy(),
                                                          clahe=clahe))


def test_hist_equalize_without_cv2_names_it(monkeypatch):
    monkeypatch.setattr(taug, "_cv2", lambda: None)
    with pytest.raises(ImportError, match="cv2"):
        taug.hist_equalize(_img(8, 8))


def test_ioa():
    boxes = np.asarray([[0, 0, 10, 10], [5, 5, 15, 15], [20, 20, 30, 30]],
                       np.float32)
    box = np.asarray([0, 0, 10, 10], np.float32)
    np.testing.assert_allclose(taug._ioa(box, boxes), [1.0, 0.25, 0.0],
                               atol=1e-6)
    np.testing.assert_allclose(taug._ioa(box, boxes), jaug._ioa(box, boxes))
