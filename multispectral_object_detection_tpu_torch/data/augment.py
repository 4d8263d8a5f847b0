"""Host image loading, letterboxing and training augmentation.

The port's counterparts of multispectral_object_detection_tpu/data/
augment.py:

- ``load_scaled``, ``load_scaled_pair`` and ``letterbox``, with the same
  geometry and the same pixels: files are read by ``data/imageio.imread``,
  resizes run in the port's C++ image runtime (``data/native.py``, cv2's
  INTER_AREA for shrinking to the longest side and INTER_LINEAR in the
  letterbox, as the JAX package calls cv2), padding is numpy;
- training: ``augment_hsv`` (HSV gains through lookup tables, drawn per
  modality), ``build_affine_matrix`` / ``warp_labels`` /
  ``random_affine_pair`` (one rotate/scale/shear/translate warp for both
  modalities, boxes or polygon segments warped with it, the reference's
  box-candidate filter) and ``mosaic4_pair`` (4 tiles on a 2s canvas, the
  same placement in both modalities);
- library augmentations that no training path calls (as in the JAX
  package): ``mosaic9_pair`` (9 tiles around a centre, a random 2s crop,
  the shared warp), ``cutout``, ``replicate`` and ``hist_equalize``
  (CLAHE or a global equalisation of the luma; needs cv2).

Every draw comes from the ``random.Random`` the caller passes, in the JAX
package's order, so one seed gives one batch. Warps and the HSV tables run
through cv2 where it is importable (the JAX package's pixels), else through
the C++ runtime, whose warp and HSV conversion round differently (within
the bounds of tests/test_torch_native.py); a perspective warp needs cv2.
"""

from __future__ import annotations

import math
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.general import _cv2
from . import native
from .imageio import imread

PAD_VALUE = 114


def _resize(im: np.ndarray, wh: Tuple[int, int], area: bool) -> np.ndarray:
    """Resize to (w, h): cv2.INTER_AREA when ``area`` (shrinking), else
    cv2.INTER_LINEAR."""
    return native.resize(im, wh[1], wh[0], area=area)


def _scale_to(im: np.ndarray, r: float) -> np.ndarray:
    if r == 1:
        return im
    return _resize(im, (int(im.shape[1] * r), int(im.shape[0] * r)), r < 1)


def load_scaled(path: str, img_size: int):
    """Decode and resize so that the longest side is ``img_size``.
    Returns (RGB uint8 image, original (h, w))."""
    im = imread(path)
    h0, w0 = im.shape[:2]
    return _scale_to(im, img_size / max(h0, w0)), (h0, w0)


def load_scaled_pair(path_rgb: str, path_ir: str, img_size: int):
    """Paired decode; the IR frame is resized with the RGB frame's ratio.
    Returns (rgb, ir, original RGB (h, w))."""
    rgb, (h0, w0) = load_scaled(path_rgb, img_size)
    ir = _scale_to(imread(path_ir), img_size / max(h0, w0))
    return rgb, ir, (h0, w0)


def letterbox(im: np.ndarray, new_shape, *, scaleup: bool = True):
    """Aspect-preserving resize (never up unless ``scaleup``) and a centred
    pad of gray 114 to ``new_shape`` (h, w).

    Returns (image, (rw, rh) gain, (dw, dh) pad on one side)."""
    shape = im.shape[:2]
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)
    ratio = (r, r)
    new_unpad = (int(round(shape[1] * r)), int(round(shape[0] * r)))
    dw = (new_shape[1] - new_unpad[0]) / 2
    dh = (new_shape[0] - new_unpad[1]) / 2
    if shape[::-1] != new_unpad:
        im = _resize(im, new_unpad, area=False)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    h, w = im.shape[:2]
    out = np.full((h + top + bottom, w + left + right) + im.shape[2:],
                  PAD_VALUE, np.uint8)
    out[top:top + h, left:left + w] = im
    return out, ratio, (dw, dh)


# ------------------------------------------------------------ augmentation
def augment_hsv(im: np.ndarray, hgain: float = 0.5, sgain: float = 0.5,
                vgain: float = 0.5, rng: Optional[random.Random] = None
                ) -> np.ndarray:
    """HSV jitter through lookup tables: gains 1 + U(-1, 1) * gain per
    channel. RGB uint8 in, a new RGB uint8 array out."""
    rng = rng or random
    r = np.array([rng.uniform(-1, 1) for _ in range(3)]) * \
        [hgain, sgain, vgain] + 1
    cv2 = _cv2()
    if cv2 is None:
        return native.hsv_jitter(im, *r)
    hue, sat, val = cv2.split(cv2.cvtColor(im, cv2.COLOR_RGB2HSV))
    x = np.arange(0, 256, dtype=np.int16)
    lut_h = ((x * r[0]) % 180).astype(im.dtype)
    lut_s = np.clip(x * r[1], 0, 255).astype(im.dtype)
    lut_v = np.clip(x * r[2], 0, 255).astype(im.dtype)
    im_hsv = cv2.merge((cv2.LUT(hue, lut_h), cv2.LUT(sat, lut_s),
                        cv2.LUT(val, lut_v))).astype(im.dtype)
    return cv2.cvtColor(im_hsv, cv2.COLOR_HSV2RGB)


def _box_candidates(box1: np.ndarray, box2: np.ndarray, wh_thr: float = 2.0,
                    ar_thr: float = 20.0, area_thr: float = 0.1) -> np.ndarray:
    """Boxes (4, n) xyxy that survived the warp: wider and taller than
    ``wh_thr`` px, at least ``area_thr`` of their area before, aspect ratio
    below ``ar_thr``."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + 1e-16), h2 / (w2 + 1e-16))
    return ((w2 > wh_thr) & (h2 > wh_thr)
            & (w2 * h2 / (w1 * h1 + 1e-16) > area_thr) & (ar < ar_thr))


def _rotation_matrix(angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D(center=(0, 0), angle, scale)."""
    a = math.radians(angle)
    alpha, beta = scale * math.cos(a), scale * math.sin(a)
    return np.array([[alpha, beta, 0.0], [-beta, alpha, 0.0]])


def build_affine_matrix(width: int, height: int, *, degrees: float = 0.0,
                        translate: float = 0.1, scale: float = 0.5,
                        shear: float = 0.0, perspective: float = 0.0,
                        border: Tuple[int, int] = (0, 0),
                        rng: Optional[random.Random] = None):
    """The warp T @ S @ R @ P @ C (centre, perspective, rotate + scale,
    shear, translate). Returns (M 3x3, the scale s, (out_w, out_h))."""
    rng = rng or random
    C = np.eye(3)
    C[0, 2] = -width / 2
    C[1, 2] = -height / 2
    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)
    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R[:2] = _rotation_matrix(a, s)
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    out_w = width + border[1] * 2
    out_h = height + border[0] * 2
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * out_w
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * out_h
    return T @ S @ R @ P @ C, s, (out_w, out_h)


def xyn2xy(seg: np.ndarray, w: float, h: float, padw: float = 0.0,
           padh: float = 0.0) -> np.ndarray:
    """Normalised polygon points (n, 2) -> pixels with an offset."""
    out = np.copy(seg).astype(np.float32)
    out[:, 0] = w * seg[:, 0] + padw
    out[:, 1] = h * seg[:, 1] + padh
    return out


def segment2box(seg: np.ndarray, width: float = 640,
                height: float = 640) -> np.ndarray:
    """A pixel polygon (n, 2) -> the xyxy box of its points inside the
    image (zeros when none is)."""
    x, y = seg.T
    inside = (x >= 0) & (y >= 0) & (x <= width) & (y <= height)
    x, y = x[inside], y[inside]
    if not x.size:
        return np.zeros(4, dtype=np.float32)
    return np.array([x.min(), y.min(), x.max(), y.max()], dtype=np.float32)


def resample_segments(segments, n: int = 1000) -> list:
    """Each (k, 2) polygon linearly resampled to (n, 2) over its vertex
    index; new arrays."""
    out = []
    for s in segments:
        s = np.asarray(s, dtype=np.float32)
        x = np.linspace(0, len(s) - 1, n)
        xp = np.arange(len(s))
        out.append(np.stack([np.interp(x, xp, s[:, i]) for i in range(2)],
                            axis=1).astype(np.float32))
    return out


def warp_labels(labels: np.ndarray, M: np.ndarray, s: float,
                out_wh: Tuple[int, int], perspective: float = 0.0,
                segments: Sequence[np.ndarray] = ()) -> np.ndarray:
    """[cls, x1, y1, x2, y2] pixel labels through the warp, then the
    candidate filter. With one pixel polygon per row (``segments``) the
    boxes come from the warped, resampled polygons' points inside the image
    (tighter than warped corners) and the area threshold is 0.01."""
    n = len(labels)
    if n == 0:
        return labels
    use_segments = len(segments) == n and any(len(sg) for sg in segments)
    if use_segments:
        new = np.zeros((n, 4), dtype=np.float32)
        for i, seg in enumerate(resample_segments(list(segments))):
            xy = np.ones((len(seg), 3))
            xy[:, :2] = seg
            xy = xy @ M.T
            xy = xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]
            new[i] = segment2box(xy, out_wh[0], out_wh[1])
    else:
        xy = np.ones((n * 4, 3))
        xy[:, :2] = labels[:, [1, 2, 3, 4, 1, 4, 3, 2]].reshape(n * 4, 2)
        xy = xy @ M.T
        xy = (xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]).reshape(
            n, 8)
        x = xy[:, [0, 2, 4, 6]]
        y = xy[:, [1, 3, 5, 7]]
        new = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], axis=1)
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, out_wh[0])
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, out_wh[1])
    keep = _box_candidates(labels[:, 1:5].T * s, new.T,
                           area_thr=0.01 if use_segments else 0.10)
    out = labels[keep].copy()
    out[:, 1:5] = new[keep]
    return out


def _warp(im: np.ndarray, M: np.ndarray, out_w: int, out_h: int,
          perspective: float) -> np.ndarray:
    cv2 = _cv2()
    if perspective:
        if cv2 is None:
            raise RuntimeError("a perspective warp needs cv2")
        return cv2.warpPerspective(im, M, dsize=(out_w, out_h),
                                   borderValue=(PAD_VALUE,) * 3)
    if cv2 is None:
        return native.warp_affine(im, M, out_h, out_w, PAD_VALUE)
    return cv2.warpAffine(im, M[:2], dsize=(out_w, out_h),
                          borderValue=(PAD_VALUE,) * 3)


def random_affine_pair(im_rgb: np.ndarray, im_ir: np.ndarray,
                       labels: np.ndarray, *, degrees: float = 0.0,
                       translate: float = 0.1, scale: float = 0.5,
                       shear: float = 0.0, perspective: float = 0.0,
                       border: Tuple[int, int] = (0, 0),
                       segments: Sequence[np.ndarray] = (),
                       rng: Optional[random.Random] = None):
    """One drawn warp applied to both modalities and the labels."""
    height, width = im_rgb.shape[0], im_rgb.shape[1]
    M, s, _ = build_affine_matrix(
        width, height, degrees=degrees, translate=translate, scale=scale,
        shear=shear, perspective=perspective, border=border, rng=rng)
    out_w, out_h = width + border[1] * 2, height + border[0] * 2
    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        im_rgb = _warp(im_rgb, M, out_w, out_h, perspective)
        im_ir = _warp(im_ir, M, out_w, out_h, perspective)
    labels = warp_labels(labels, M, s, (out_w, out_h), perspective,
                         segments=segments)
    return im_rgb, im_ir, labels


def mosaic4_pair(load_fn, indices: Sequence[int], img_size: int, hyp: dict,
                 rng: Optional[random.Random] = None):
    """4-tile mosaic with the same placement in both modalities, then the
    shared warp cropping the 2s canvas to s.

    load_fn(i) -> (rgb, ir, labels [cls, x, y, w, h] normalised to the
    loaded image[, per-row normalised polygons]). Returns (rgb, ir,
    labels [cls, x1, y1, x2, y2] in pixels) at img_size x img_size."""
    rng = rng or random
    s = img_size
    yc = int(rng.uniform(s // 2, 2 * s - s // 2))
    xc = int(rng.uniform(s // 2, 2 * s - s // 2))
    canvas_rgb = np.full((s * 2, s * 2, 3), PAD_VALUE, dtype=np.uint8)
    canvas_ir = np.full((s * 2, s * 2, 3), PAD_VALUE, dtype=np.uint8)
    all_labels: List[np.ndarray] = []
    all_segments: List[np.ndarray] = []
    for i, idx in enumerate(indices):
        loaded = load_fn(idx)
        rgb, ir, labels = loaded[:3]
        segs = loaded[3] if len(loaded) > 3 else []
        h, w = rgb.shape[:2]
        if i == 0:  # top-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
        elif i == 1:  # top-right
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
            x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
        elif i == 2:  # bottom-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
            x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
        else:  # bottom-right
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2,
                                                                  yc + h)
            x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
        canvas_rgb[y1a:y2a, x1a:x2a] = rgb[y1b:y2b, x1b:x2b]
        canvas_ir[y1a:y2a, x1a:x2a] = ir[y1b:y2b, x1b:x2b]
        padw, padh = x1a - x1b, y1a - y1b
        if labels.size:
            lab = labels
            out = np.empty_like(lab)
            out[:, 0] = lab[:, 0]
            out[:, 1] = w * (lab[:, 1] - lab[:, 3] / 2) + padw
            out[:, 2] = h * (lab[:, 2] - lab[:, 4] / 2) + padh
            out[:, 3] = w * (lab[:, 1] + lab[:, 3] / 2) + padw
            out[:, 4] = h * (lab[:, 2] + lab[:, 4] / 2) + padh
            all_labels.append(out)
            all_segments.extend(xyn2xy(sg, w, h, padw, padh) for sg in segs)
    labels = (np.concatenate(all_labels, 0) if all_labels
              else np.zeros((0, 5), dtype=np.float32))
    labels[:, 1:5] = labels[:, 1:5].clip(0, 2 * s)
    for sg in all_segments:
        np.clip(sg, 0, 2 * s, out=sg)
    return random_affine_pair(
        canvas_rgb, canvas_ir, labels,
        degrees=hyp.get("degrees", 0.0), translate=hyp.get("translate", 0.1),
        scale=hyp.get("scale", 0.5), shear=hyp.get("shear", 0.0),
        perspective=hyp.get("perspective", 0.0),
        border=(-s // 2, -s // 2), segments=all_segments, rng=rng)


def mosaic9_pair(load_fn, indices: Sequence[int], img_size: int, hyp: dict,
                 rng: Optional[random.Random] = None):
    """9-tile mosaic with the same placement in both modalities: tiles laid
    clockwise around the centre image on a 3s canvas, each anchored to the
    previous one's extent, a random 2s crop, then the shared warp to s.
    ``load_fn`` and the result as ``mosaic4_pair``."""
    rng = rng or random
    s = img_size
    canvas_rgb = canvas_ir = None
    all_labels: List[np.ndarray] = []
    all_segments: List[np.ndarray] = []
    h0 = w0 = hp = wp = 0
    for i, idx in enumerate(indices):
        loaded = load_fn(idx)
        rgb, ir, labels = loaded[:3]
        segs = loaded[3] if len(loaded) > 3 else []
        h, w = rgb.shape[:2]
        if i == 0:    # centre
            canvas_rgb = np.full((s * 3, s * 3, 3), PAD_VALUE, dtype=np.uint8)
            canvas_ir = np.full((s * 3, s * 3, 3), PAD_VALUE, dtype=np.uint8)
            h0, w0 = h, w
            c = s, s, s + w, s + h
        elif i == 1:  # top
            c = s, s - h, s + w, s
        elif i == 2:  # top right
            c = s + wp, s - h, s + wp + w, s
        elif i == 3:  # right
            c = s + w0, s, s + w0 + w, s + h
        elif i == 4:  # bottom right
            c = s + w0, s + hp, s + w0 + w, s + hp + h
        elif i == 5:  # bottom
            c = s + w0 - w, s + h0, s + w0, s + h0 + h
        elif i == 6:  # bottom left
            c = s + w0 - wp - w, s + h0, s + w0 - wp, s + h0 + h
        elif i == 7:  # left
            c = s - w, s + h0 - h, s, s + h0
        else:         # top left
            c = s - w, s + h0 - hp - h, s, s + h0 - hp
        padx, pady = c[:2]
        x1, y1, x2, y2 = (max(v, 0) for v in c)
        canvas_rgb[y1:y2, x1:x2] = \
            rgb[y1 - pady:, x1 - padx:][:y2 - y1, :x2 - x1]
        canvas_ir[y1:y2, x1:x2] = \
            ir[y1 - pady:, x1 - padx:][:y2 - y1, :x2 - x1]
        if labels.size:
            lab = labels
            out = np.empty_like(lab)
            out[:, 0] = lab[:, 0]
            out[:, 1] = w * (lab[:, 1] - lab[:, 3] / 2) + padx
            out[:, 2] = h * (lab[:, 2] - lab[:, 4] / 2) + pady
            out[:, 3] = w * (lab[:, 1] + lab[:, 3] / 2) + padx
            out[:, 4] = h * (lab[:, 2] + lab[:, 4] / 2) + pady
            all_labels.append(out)
            all_segments.extend(xyn2xy(sg, w, h, padx, pady) for sg in segs)
        hp, wp = h, w
    yc = int(rng.uniform(0, s))
    xc = int(rng.uniform(0, s))
    canvas_rgb = canvas_rgb[yc:yc + 2 * s, xc:xc + 2 * s]
    canvas_ir = canvas_ir[yc:yc + 2 * s, xc:xc + 2 * s]
    labels = (np.concatenate(all_labels, 0) if all_labels
              else np.zeros((0, 5), dtype=np.float32))
    if labels.size:
        labels[:, [1, 3]] -= xc
        labels[:, [2, 4]] -= yc
    labels[:, 1:5] = labels[:, 1:5].clip(0, 2 * s)
    for sg in all_segments:
        sg[:, 0] -= xc
        sg[:, 1] -= yc
        np.clip(sg, 0, 2 * s, out=sg)
    return random_affine_pair(
        canvas_rgb, canvas_ir, labels,
        degrees=hyp.get("degrees", 0.0), translate=hyp.get("translate", 0.1),
        scale=hyp.get("scale", 0.5), shear=hyp.get("shear", 0.0),
        perspective=hyp.get("perspective", 0.0),
        border=(-s // 2, -s // 2), segments=all_segments, rng=rng)


def hist_equalize(im: np.ndarray, clahe: bool = True) -> np.ndarray:
    """Histogram equalisation of an RGB uint8 image's luma (Y of YUV):
    CLAHE (clip 2, 8x8 tiles) or a global ``equalizeHist``. Needs cv2."""
    cv2 = _cv2()
    if cv2 is None:
        raise ImportError("hist_equalize needs cv2 (opencv-python), which "
                          "is not installed")
    yuv = cv2.cvtColor(im, cv2.COLOR_RGB2YUV)
    if clahe:
        yuv[:, :, 0] = cv2.createCLAHE(
            clipLimit=2.0, tileGridSize=(8, 8)).apply(yuv[:, :, 0])
    else:
        yuv[:, :, 0] = cv2.equalizeHist(yuv[:, :, 0])
    return cv2.cvtColor(yuv, cv2.COLOR_YUV2RGB)


def _ioa(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Intersection of ``box`` (4,) over the area of each of ``boxes``
    (N, 4), xyxy."""
    ix = (np.minimum(box[2], boxes[:, 2])
          - np.maximum(box[0], boxes[:, 0])).clip(0)
    iy = (np.minimum(box[3], boxes[:, 3])
          - np.maximum(box[1], boxes[:, 1])).clip(0)
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]) + 1e-16
    return ix * iy / area


def cutout(im: np.ndarray, labels: np.ndarray,
           rng: Optional[random.Random] = None) -> np.ndarray:
    """Paint random gray patches into ``im`` in place at halving scales;
    labels (N, 5) [cls, x1, y1, x2, y2] px more than 60 % covered by a
    patch larger than 3 % are dropped. Returns the surviving labels."""
    rng = rng or random
    h, w = im.shape[:2]
    scales = [0.5] + [0.25] * 2 + [0.125] * 4 + [0.0625] * 8 + [0.03125] * 16
    for s in scales:
        mh = rng.randint(1, max(int(h * s), 1))
        mw = rng.randint(1, max(int(w * s), 1))
        x1 = max(0, rng.randint(0, w) - mw // 2)
        y1 = max(0, rng.randint(0, h) - mh // 2)
        x2, y2 = min(w, x1 + mw), min(h, y1 + mh)
        im[y1:y2, x1:x2] = [rng.randint(64, 191) for _ in range(3)]
        if len(labels) and s > 0.03:
            box = np.asarray([x1, y1, x2, y2], np.float32)
            labels = labels[_ioa(box, labels[:, 1:5]) < 0.60]
    return labels


def replicate(im: np.ndarray, labels: np.ndarray,
              rng: Optional[random.Random] = None):
    """Copy the smaller half of the boxes (by mean side) to random places
    in ``im`` (in place); labels (N, 5) [cls, x1, y1, x2, y2] px. Returns
    (im, labels with the copies appended)."""
    rng = rng or random
    h, w = im.shape[:2]
    boxes = labels[:, 1:5].astype(int)
    side = ((boxes[:, 2] - boxes[:, 0]) + (boxes[:, 3] - boxes[:, 1])) / 2
    for i in side.argsort()[:round(side.size * 0.5)]:
        x1b, y1b, x2b, y2b = boxes[i]
        bh, bw = y2b - y1b, x2b - x1b
        if bh <= 0 or bw <= 0 or bh >= h or bw >= w:
            continue
        yc, xc = int(rng.uniform(0, h - bh)), int(rng.uniform(0, w - bw))
        im[yc:yc + bh, xc:xc + bw] = im[y1b:y2b, x1b:x2b]
        labels = np.append(labels, [[labels[i, 0], xc, yc, xc + bw, yc + bh]],
                           axis=0)
    return im, labels
