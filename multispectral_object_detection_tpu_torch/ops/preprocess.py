"""Batched letterbox on the device: resize, gray pad and /255 as torch ops.

Counterpart of ``letterbox_params`` and ``letterbox_batch`` in
multispectral_object_detection_tpu/ops/preprocess.py: a bilinear resize
with half-pixel centres (``F.interpolate``, align_corners=False, no
antialiasing: the JAX package's ``_bilinear_matrix``), a centred pad of
gray 114 to the square canvas, and the division by 255 in the same pass.
The host letterbox (``data/augment.letterbox``, cv2's fixed-point
arithmetic) and this one differ by bilinear rounding only.
``hsv_jitter_batch`` comes with the training slice.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

PAD_VALUE = 114.0


def letterbox_params(src_hw: Tuple[int, int], img_size: int,
                     scaleup: bool = True):
    """The host letterbox's geometry for one source shape: (resized (h, w),
    (gain, gain), (padw, padh) on one side)."""
    h, w = src_hw
    r = min(img_size / h, img_size / w)
    if not scaleup:
        r = min(r, 1.0)
    new_unpad = (int(round(w * r)), int(round(h * r)))
    dw = (img_size - new_unpad[0]) / 2
    dh = (img_size - new_unpad[1]) / 2
    return (new_unpad[1], new_unpad[0]), (r, r), (dw, dh)


def letterbox_batch(imgs: torch.Tensor, img_size: int, *,
                    scaleup: bool = True, dtype: torch.dtype = torch.float32,
                    normalize: bool = True) -> torch.Tensor:
    """uint8 (B, H0, W0, 3) on any device -> (B, S, S, 3) in ``dtype``,
    letterboxed (and / 255 when ``normalize``), on the same device."""
    b, h0, w0, c = imgs.shape
    (nh, nw), _, (dw, dh) = letterbox_params((h0, w0), img_size, scaleup)
    x = imgs.permute(0, 3, 1, 2).float()
    if (nh, nw) != (h0, w0):
        x = F.interpolate(x, size=(nh, nw), mode="bilinear",
                          align_corners=False)
    top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
    x = F.pad(x, (left, img_size - nw - left, top, img_size - nh - top),
              value=PAD_VALUE)
    if normalize:
        x = x / 255.0
    return x.permute(0, 2, 3, 1).to(dtype)
