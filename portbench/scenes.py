"""Seeded synthetic scenes, letterboxed to the canvas, made on the device.

A frozen copy of the program's ``data/synthetic.make_scene`` recipe, drawn
with a ``torch.Generator`` so that a pool of batches takes milliseconds: a
textured background (RGB 20-60, thermal 180-220), 1 to ``max_objects``
filled rectangles per image of 1/8 to 1/3 of the frame on each axis (RGB
in the class's colour, thermal 30), the label rows [class, cx, cy, w, h]
normalised to the frame. The frame is the configuration's native
``frame_hw`` (LLVIP's 1024 x 1280) scaled into the canvas, as a letterbox
does, and centred on grey 114.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .seeds import derive

PALETTE = [(220, 60, 60), (60, 60, 220), (60, 200, 60), (230, 200, 40),
           (200, 60, 200), (40, 220, 220), (240, 140, 40), (140, 90, 40)]
PAD = 114


def letterbox_hw(frame_hw, canvas_hw) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """(content (h, w), (top, left)) of a frame scaled into the canvas with
    its aspect kept, centred (cv2-style rounding of the padding)."""
    r = min(canvas_hw[0] / frame_hw[0], canvas_hw[1] / frame_hw[1])
    h, w = round(frame_hw[0] * r), round(frame_hw[1] * r)
    top = round((canvas_hw[0] - h) / 2 - 0.1)
    left = round((canvas_hw[1] - w) / 2 - 0.1)
    return (h, w), (top, left)


def scene_batch(g: torch.Generator, batch: int, canvas_hw, frame_hw, nc: int,
                max_objects: int, device) -> Tuple[torch.Tensor, torch.Tensor,
                                                   List[np.ndarray]]:
    """(rgb, ir) uint8 (B, H, W, 3) on ``device`` and per image its label
    rows (n, 5) [class, cx, cy, w, h], normalised to the canvas."""
    H, W = canvas_hw
    (h, w), (top, left) = letterbox_hw(frame_hw, canvas_hw)
    rgb = torch.full((batch, H, W, 3), PAD, dtype=torch.uint8, device=device)
    ir = rgb.clone()
    rgb[:, top:top + h, left:left + w] = (torch.rand(
        (batch, h, w, 3), generator=g, device=device) * 40 + 20).to(torch.uint8)
    ir[:, top:top + h, left:left + w] = (torch.rand(
        (batch, h, w, 3), generator=g, device=device) * 40 + 180).to(torch.uint8)
    # the rectangles' draws, all at once on the host side of the generator
    n_obj = torch.randint(1, max_objects + 1, (batch,), generator=g,
                          device=device).tolist()
    draws = torch.rand((batch, max_objects, 5), generator=g,
                       device=device).double().cpu().numpy()
    labels = []
    for b in range(batch):
        rows = []
        for j in range(n_obj[b]):
            u = draws[b, j]
            cls = min(int(u[0] * nc), nc - 1)
            bw = w // 8 + int(u[1] * (w // 3 - w // 8))
            bh = h // 8 + int(u[2] * (h // 3 - h // 8))
            x1 = int(u[3] * (w - bw))
            y1 = int(u[4] * (h - bh))
            ys, xs = top + y1, left + x1
            rgb[b, ys:ys + bh + 1, xs:xs + bw + 1] = torch.tensor(
                PALETTE[cls % len(PALETTE)], dtype=torch.uint8, device=device)
            ir[b, ys:ys + bh + 1, xs:xs + bw + 1] = 30
            rows.append((cls, (xs + bw / 2) / W, (ys + bh / 2) / H, bw / W,
                         bh / H))
        labels.append(np.asarray(rows, np.float32).reshape(-1, 5))
    return rgb, ir, labels


def scene_pool(seed: int, n_batches: int, batch: int, canvas_hw, frame_hw,
               nc: int, max_objects: int, device):
    """``n_batches`` distinct batches for ``seed``, handed over as a user
    would: host uint8 numpy arrays (rgb, ir, labels)."""
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, "scenes"))
    pool = []
    for _ in range(n_batches):
        rgb, ir, labels = scene_batch(g, batch, canvas_hw, frame_hw, nc,
                                      max_objects, device)
        pool.append((rgb.cpu().numpy(), ir.cpu().numpy(), labels))
    return pool
