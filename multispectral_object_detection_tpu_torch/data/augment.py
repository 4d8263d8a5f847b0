"""Loading and letterboxing of evaluation and serving images (no
augmentation).

The port's counterparts of ``load_scaled``, ``load_scaled_pair`` and
``letterbox`` in multispectral_object_detection_tpu/data/augment.py, with
the same geometry and the same pixels: files are read by
``data/imageio.imread``, resizes run in the port's C++ image runtime
(``data/native.py``, cv2's INTER_AREA for shrinking to the longest side and
INTER_LINEAR in the letterbox, as the JAX package calls cv2), padding is
numpy. Training's augmentations (mosaic, affine, HSV, flips) wait for the
training slice.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

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
