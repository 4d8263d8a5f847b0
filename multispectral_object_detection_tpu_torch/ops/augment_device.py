"""Paired mosaic + scale/translate + flip + HSV augmentation on the device.

Counterpart of multispectral_object_detection_tpu/ops/augment_device.py,
the ``--device-aug`` path: the host only decodes and letterboxes tiles
(data/datasets.collate_tiles), and the rest runs on the card as torch ops:

- four s x s tiles per sample meet at a drawn corner (yc, xc) on a padded
  3s x 3s canvas of gray 114, placed by slicing per sample;
- the default recipe's warp (degrees = shear = perspective = 0) is a
  scale r and a translation, separable in y and x: two batched bilinear
  resampling products ``W_y @ canvas @ W_x^T`` with the gray fill
  ``(1 - cover) * 114`` where the source falls outside the canvas;
- a horizontal flip shared by both modalities, rounding to uint8, HSV
  jitter per modality (ops/preprocess.hsv_jitter_batch);
- the labels follow the same transform, with the reference's box-candidate
  filter as a mask.

The draws are separate from the transform: ``draw_mosaic`` takes them from
a ``torch.Generator``, ``device_mosaic_batch`` is a pure function of tiles,
labels and draws (the tests pass in the draws of the JAX package's key).
"""

from __future__ import annotations

from typing import Dict

import torch

from .preprocess import draw_hsv_factors, hsv_jitter_batch

PAD_VALUE = 114.0


def draw_mosaic(generator: torch.Generator, batch: int, img_size: int,
                hyp: dict) -> Dict[str, torch.Tensor]:
    """The random draws of one batch, on the generator's device: per sample
    ``yc``, ``xc`` (int64, the tiles' common corner on the 2s canvas in
    [s/2, 3s/2)), ``r`` (scale in 1 -/+ hyp["scale"]) and ``tshift`` (B, 2)
    (x, y translation in px); per batch ``flip`` (B,) bool with
    probability hyp["fliplr"]; ``hsv_rgb`` and ``hsv_ir`` (B, 3) factors
    from the gains hyp["hsv_h"], ["hsv_s"], ["hsv_v"]."""
    s, dev = img_size, generator.device
    lo, hi = s // 2, 2 * s - s // 2
    sj, tr = hyp.get("scale", 0.5), hyp.get("translate", 0.1)

    def uniform(shape, a, b):
        return torch.rand(shape, generator=generator, device=dev) * (b - a) + a

    gains = (hyp.get("hsv_h", 0.015), hyp.get("hsv_s", 0.7),
             hyp.get("hsv_v", 0.4))
    return {
        "yc": torch.randint(lo, hi, (batch,), generator=generator, device=dev),
        "xc": torch.randint(lo, hi, (batch,), generator=generator, device=dev),
        "r": uniform((batch,), 1.0 - sj, 1.0 + sj),
        "tshift": uniform((batch, 2), 0.5 - tr, 0.5 + tr) * s,
        "flip": torch.rand((batch,), generator=generator,
                           device=dev) < hyp.get("fliplr", 0.5),
        "hsv_rgb": draw_hsv_factors(generator, batch, gains),
        "hsv_ir": draw_hsv_factors(generator, batch, gains),
    }


def take_rows(draws: Dict[str, torch.Tensor], start: int,
              stop: int) -> Dict[str, torch.Tensor]:
    """The draws of samples [start, stop) (one rank's rows of a batch)."""
    return {k: v[start:stop] for k, v in draws.items()}


def _resample_matrices(size_out: int, size_in: int, scale: torch.Tensor,
                       shift: torch.Tensor) -> torch.Tensor:
    """(B, out, in) bilinear weights of src = (i - shift) / scale; rows
    whose source leaves [0, in - 1] sum to less than 1."""
    dev = scale.device
    i = torch.arange(size_out, dtype=torch.float32, device=dev)[None, :, None]
    j = torch.arange(size_in, dtype=torch.float32, device=dev)[None, None, :]
    src = (i - shift[:, None, None]) / scale[:, None, None]
    return torch.clamp(1.0 - (src - j).abs(), min=0.0)


def _warp(canvas: torch.Tensor, wy: torch.Tensor,
          wx: torch.Tensor) -> torch.Tensor:
    """canvas (B, H, W, 3) fp32 -> (B, out, out, 3) = wy @ canvas @ wx^T per
    channel, plus the gray fill of the weight each output pixel lacks."""
    b, h, w, c = canvas.shape
    out = wy.shape[1]
    y = torch.bmm(wy, canvas.reshape(b, h, w * c)).view(b, out, w, c)
    y = torch.bmm(y.permute(0, 1, 3, 2).reshape(b, out * c, w),
                  wx.transpose(1, 2)).view(b, out, c, out).permute(0, 1, 3, 2)
    cover = wy.sum(2)[:, :, None] * wx.sum(2)[:, None, :]
    return y + (1.0 - cover)[..., None] * PAD_VALUE


def device_mosaic_batch(tiles_rgb: torch.Tensor, tiles_ir: torch.Tensor,
                        labels: torch.Tensor, lmask: torch.Tensor,
                        draws: Dict[str, torch.Tensor], img_size: int):
    """tiles_rgb/ir uint8 (B, 4, s, s, 3) letterboxed tiles (TL, TR, BL, BR)
    on the device; labels (B, 4, M, 5) [cls, x, y, w, h] normalised per
    tile, lmask (B, 4, M); ``draws`` from ``draw_mosaic``. Returns uint8
    rgb and ir (B, s, s, 3), targets (B, 4M, 5) [cls, x, y, w, h]
    normalised and mask (B, 4M) fp32, on the tiles' device."""
    s = img_size
    B = tiles_rgb.shape[0]
    dev = tiles_rgb.device
    pad = s // 2
    yc = [int(v) for v in draws["yc"].tolist()]
    xc = [int(v) for v in draws["xc"].tolist()]
    r = draws["r"].to(dev, torch.float32)
    tshift = draws["tshift"].to(dev, torch.float32)
    flip = draws["flip"].to(dev)

    # the four tiles on the padded canvas, corners meeting at (yc, xc)
    outs = []
    for tiles in (tiles_rgb, tiles_ir):
        canvas = torch.full((B, 3 * s, 3 * s, 3), PAD_VALUE,
                            dtype=torch.float32, device=dev)
        for b in range(B):
            yo, xo = yc[b] + pad, xc[b] + pad
            for t, (y0, x0) in enumerate(((yo - s, xo - s), (yo - s, xo),
                                          (yo, xo - s), (yo, xo))):
                canvas[b, y0:y0 + s, x0:x0 + s] = tiles[b, t]
        # padded -> output: x_out = (x_pad - pad - s) * r + t
        wy = _resample_matrices(s, 3 * s, r, tshift[:, 1] - (pad + s) * r)
        wx = _resample_matrices(s, 3 * s, r, tshift[:, 0] - (pad + s) * r)
        out = _warp(canvas, wy, wx)
        del canvas
        out = torch.where(flip[:, None, None, None], out.flip(2), out)
        outs.append(torch.clamp(torch.round(out), 0, 255).to(torch.uint8))
    rgb_u8 = hsv_jitter_batch(outs[0], draws["hsv_rgb"])
    ir_u8 = hsv_jitter_batch(outs[1], draws["hsv_ir"])

    # labels: tile -> canvas px (xyxy, clipped to the 2s canvas)
    yc_t = torch.tensor(yc, dtype=torch.float32, device=dev)
    xc_t = torch.tensor(xc, dtype=torch.float32, device=dev)
    offs = torch.stack([
        torch.stack([xc_t - s, yc_t - s], -1), torch.stack([xc_t, yc_t - s], -1),
        torch.stack([xc_t - s, yc_t], -1), torch.stack([xc_t, yc_t], -1)],
        1)                                                   # (B, 4, 2)
    labels = labels.to(dev, torch.float32)
    M = labels.shape[2]
    cls = labels[..., 0].reshape(B, 4 * M)
    xy = labels[..., 1:3] * s + offs[:, :, None, :]
    wh = labels[..., 3:5] * s
    boxes = torch.cat([xy - wh / 2, xy + wh / 2], -1).reshape(B, 4 * M, 4)
    boxes = torch.clamp(boxes, 0.0, 2.0 * s)
    mask = lmask.to(dev, torch.float32).reshape(B, 4 * M)

    # canvas -> output px, then the box-candidate filter
    rr = r[:, None]
    bx = boxes * rr[..., None]
    shift = torch.stack([tshift[:, 0] - s * r, tshift[:, 1] - s * r], -1)
    bx = bx + torch.cat([shift, shift], -1)[:, None, :]
    w_before = (boxes[..., 2] - boxes[..., 0]) * rr
    h_before = (boxes[..., 3] - boxes[..., 1]) * rr
    bx = torch.clamp(bx, 0.0, float(s))
    w_after = bx[..., 2] - bx[..., 0]
    h_after = bx[..., 3] - bx[..., 1]
    ar = torch.maximum(w_after / (h_after + 1e-16), h_after / (w_after + 1e-16))
    keep = ((w_after > 2.0) & (h_after > 2.0) & (ar < 20.0)
            & (w_after * h_after / (w_before * h_before + 1e-16) > 0.1))
    mask = mask * keep.float()

    f = flip[:, None]
    x1 = torch.where(f, s - bx[..., 2], bx[..., 0])
    x2 = torch.where(f, s - bx[..., 0], bx[..., 2])
    y1, y2 = bx[..., 1], bx[..., 3]
    targets = torch.stack([cls, (x1 + x2) / 2 / s, (y1 + y2) / 2 / s,
                           (x2 - x1) / s, (y2 - y1) / s], -1)
    return rgb_u8, ir_u8, targets, mask


def image_targets(targets: torch.Tensor, mask: torch.Tensor):
    """(B, K, 5) targets and (B, K) mask -> the train step's (B*K, 6)
    [img, cls, x, y, w, h] and (B*K,) mask, image index prepended."""
    B, K = mask.shape
    idx = torch.arange(B, dtype=torch.float32,
                       device=targets.device)[:, None, None].expand(B, K, 1)
    return torch.cat([idx, targets], -1).reshape(B * K, 6), mask.reshape(-1)

