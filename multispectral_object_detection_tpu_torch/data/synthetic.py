"""Synthetic paired RGB/IR detection data, written without cv2.

The port's counterpart of multispectral_object_detection_tpu/data/
synthetic.py: the same random draws in the same order from the same seed,
so the same scenes and the same label files. Filled rectangles of a colour
per class on a textured background; the IR frame has the same geometry with
dark objects on a bright background. Images are written as PNG (JPEG bytes
differ between encoders; PNG is lossless), so both packages read the same
pixels from them.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .imageio import write_png

PALETTE = [(220, 60, 60), (60, 60, 220), (60, 200, 60), (230, 200, 40),
           (200, 60, 200), (40, 220, 220), (240, 140, 40), (140, 90, 40)]


def make_scene(rng: np.random.Generator, h: int, w: int, nc: int = 2,
               max_objects: int = 5):
    """One synthetic pair: (rgb, ir) uint8 (h, w, 3) and its label rows
    [cls, cx, cy, w, h] normalised (label files round them to 6
    decimals)."""
    rgb = rng.uniform(20, 60, size=(h, w, 3)).astype(np.uint8)
    ir = rng.uniform(180, 220, size=(h, w, 3)).astype(np.uint8)
    rows = []
    for _ in range(int(rng.integers(1, max_objects + 1))):
        cls = int(rng.integers(0, nc))
        bw = int(rng.integers(w // 8, w // 3))
        bh = int(rng.integers(h // 8, h // 3))
        x1 = int(rng.integers(0, w - bw))
        y1 = int(rng.integers(0, h - bh))
        # a filled rectangle with both corners inside, as cv2 draws it
        rgb[y1:y1 + bh + 1, x1:x1 + bw + 1] = PALETTE[cls % len(PALETTE)]
        ir[y1:y1 + bh + 1, x1:x1 + bw + 1] = 30
        rows.append((cls, (x1 + bw / 2) / w, (y1 + bh / 2) / h, bw / w,
                     bh / h))
    return rgb, ir, rows


def make_paired_dataset(root: str, n_images: int = 16, img_size: int = 256,
                        nc: int = 2, max_objects: int = 5, seed: int = 0,
                        img_hw: Optional[Tuple[int, int]] = None
                        ) -> Tuple[str, str]:
    """Write ``root/{rgb,ir}/images/*.png`` and ``root/rgb/labels/*.txt``;
    returns (rgb image dir, IR image dir).

    img_hw: (height, width) for non-square images (box sizes and places
    are drawn per axis); square ``img_size`` when None."""
    h, w = img_hw if img_hw is not None else (img_size, img_size)
    rng = np.random.default_rng(seed)
    rgb_img = Path(root) / "rgb" / "images"
    rgb_lab = Path(root) / "rgb" / "labels"
    ir_img = Path(root) / "ir" / "images"
    for d in (rgb_img, rgb_lab, ir_img):
        d.mkdir(parents=True, exist_ok=True)
    for k in range(n_images):
        rgb, ir, rows = make_scene(rng, h, w, nc, max_objects)
        lines = [f"{c} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}"
                 for c, cx, cy, bw, bh in rows]
        name = f"{k:06d}"
        write_png(rgb_img / f"{name}.png", rgb)
        write_png(ir_img / f"{name}.png", ir)
        (rgb_lab / f"{name}.txt").write_text("\n".join(lines) + "\n")
    return str(rgb_img), str(ir_img)


def synthetic_batch(batch: int, img_size: int, nc: int = 2,
                    max_labels: int = 64, seed: int = 0):
    """A training batch of ``make_scene`` pairs in memory: rgb, ir uint8
    (batch, img_size, img_size, 3), targets (batch * max_labels, 6)
    [img, cls, x, y, w, h] and tmask (batch * max_labels,), the collated
    layout of data/datasets.py."""
    rng = np.random.default_rng(seed)
    rgb = np.empty((batch, img_size, img_size, 3), np.uint8)
    ir = np.empty_like(rgb)
    targets = np.zeros((batch * max_labels, 6), np.float32)
    tmask = np.zeros((batch * max_labels,), np.float32)
    for b in range(batch):
        rgb[b], ir[b], rows = make_scene(rng, img_size, img_size, nc)
        for j, row in enumerate(rows[:max_labels]):
            targets[b * max_labels + j] = (b, *row)
            tmask[b * max_labels + j] = 1.0
    return rgb, ir, targets, tmask
