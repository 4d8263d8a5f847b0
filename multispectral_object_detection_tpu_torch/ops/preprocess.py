"""Batched letterbox on the device: resize, gray pad and /255 as torch ops.

Counterpart of ``letterbox_params`` and ``letterbox_batch`` in
multispectral_object_detection_tpu/ops/preprocess.py: a bilinear resize
with half-pixel centres (``F.interpolate``, align_corners=False, no
antialiasing: the JAX package's ``_bilinear_matrix``), a centred pad of
gray 114 to the square canvas, and the division by 255 in the same pass.
The host letterbox (``data/augment.letterbox``, cv2's fixed-point
arithmetic) and this one differ by bilinear rounding only.

``hsv_jitter_batch`` is the training-time HSV jitter of a uint8 batch on
the device (the ``--device-aug`` path, ops/augment_device.py): RGB to HSV
in fp32, per-image factors on hue, saturation and value, back to uint8.
The factors are an argument; ``draw_hsv_factors`` draws them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

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


def draw_hsv_factors(generator: torch.Generator, n: int,
                     gains: Sequence[float]) -> torch.Tensor:
    """(n, 3) per-image [h, s, v] factors ``uniform(-1, 1) * gains + 1``,
    drawn from ``generator`` on its device."""
    u = torch.rand((n, 3), generator=generator,
                   device=generator.device) * 2.0 - 1.0
    return u * torch.tensor(gains, dtype=torch.float32,
                            device=generator.device) + 1.0


def hsv_jitter_batch(imgs: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) RGB -> uint8, hue, saturation and value of image
    b scaled by ``factors[b]`` (B, 3) in fp32 HSV space (the JAX package's
    arithmetic, LUT-free; the host path's ``augment_hsv`` uses tables)."""
    r = factors.to(device=imgs.device, dtype=torch.float32)[:, None, None, :]
    x = imgs.float() / 255.0
    mx = x.amax(-1)
    mn = x.amin(-1)
    v = mx
    s = torch.where(mx > 0, (mx - mn) / torch.clamp(mx, min=1e-9),
                    torch.zeros_like(mx))
    rc, gc, bc = x.unbind(-1)
    df = torch.clamp(mx - mn, min=1e-9)
    h = torch.where(mx == rc, (gc - bc) / df,
                    torch.where(mx == gc, 2.0 + (bc - rc) / df,
                                4.0 + (rc - gc) / df))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.remainder(h * r[..., 0], 1.0)
    s = torch.clamp(s * r[..., 1], 0.0, 1.0)
    v = torch.clamp(v * r[..., 2], 0.0, 1.0)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)
    def pick(c0, c1, c2, c3, c4, c5):  # the value of sector i
        out = c5
        for k, c in ((4, c4), (3, c3), (2, c2), (1, c1), (0, c0)):
            out = torch.where(i == k, c, out)
        return out

    rgb = torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                       pick(p, p, t, v, v, q)], -1)
    return torch.clamp(torch.round(rgb * 255.0), 0, 255).to(torch.uint8)
