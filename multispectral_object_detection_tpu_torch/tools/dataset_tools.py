"""Dataset utilities (reference utils/datasets.py:1971-2042): autosplit,
extract_boxes, flatten_recursive. The port's counterpart of
``tools/dataset_tools.py``, with its flags and output lines.

    python -m multispectral_object_detection_tpu_torch.tools.dataset_tools \\
        autosplit --path DIR [--weights 0.9 0.1 0.0]
    python -m ... extract-boxes --path DIR
    python -m ... flatten --path DIR

``autosplit`` draws from ``random.Random(0)`` as the JAX tool does, so the
lists are the same. ``extract_boxes`` reads labels through
``data/datasets.py``; with cv2 installed it reads and writes crops through
cv2 (``.jpg``), as the JAX tool does; without it (the GPU machine) images
are read by ``data/imageio.py`` (PNG; JPEG through the native decoder) and
crops are written as PNG, a divergence it logs.
"""

from __future__ import annotations

import argparse
import logging
import random
import shutil
import sys
from pathlib import Path

from ..data.datasets import IMG_EXTS

logger = logging.getLogger(__name__)

SPLITS = ("autosplit_train.txt", "autosplit_val.txt", "autosplit_test.txt")


def autosplit(path: str, weights=(0.9, 0.1, 0.0), seed: int = 0) -> dict:
    """Write autosplit_{train,val,test}.txt beside ``path`` listing its
    images by random split; returns {file name: [image paths]}."""
    p = Path(path)
    files = sorted(f for f in p.rglob("*") if f.suffix.lower() in IMG_EXTS)
    rng = random.Random(seed)
    for n in SPLITS:
        (p.parent / n).unlink(missing_ok=True)
    out = {n: [] for n in SPLITS}
    for f in files:
        r = rng.random()
        i = 0 if r < weights[0] else (1 if r < weights[0] + weights[1] else 2)
        with open(p.parent / SPLITS[i], "a") as fh:
            fh.write(str(f) + "\n")
        out[SPLITS[i]].append(str(f))
    print(f"split {len(files)} images -> {list(SPLITS)}")
    return out


def extract_boxes(path: str) -> list:
    """Crop every labelled box into ``<path>/../classifier/<class>/
    <stem>_<row>.<ext>`` (a classification dataset); returns the crops
    written."""
    import numpy as np

    from ..data.datasets import image_to_label_path, read_label_file

    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is None:
        logger.info("extract-boxes: cv2 is not installed; crops are written "
                    "as PNG (the reference writes JPEG through cv2)")
        from ..data.imageio import imread, write_png
    p = Path(path)
    out = p.parent / "classifier"
    crops = []
    for f in sorted(p.rglob("*")):
        if f.suffix.lower() not in IMG_EXTS:
            continue
        lab, _ = read_label_file(image_to_label_path(str(f)))
        if not len(lab):
            continue
        im = cv2.imread(str(f)) if cv2 is not None else imread(f)
        h, w = im.shape[:2]
        for j, row in enumerate(lab):
            c = int(row[0])
            b = row[1:] * np.array([w, h, w, h])
            x1 = int(max(b[0] - b[2] / 2, 0))
            y1 = int(max(b[1] - b[3] / 2, 0))
            x2 = int(min(b[0] + b[2] / 2, w))
            y2 = int(min(b[1] + b[3] / 2, h))
            d = out / str(c)
            d.mkdir(parents=True, exist_ok=True)
            if cv2 is not None:
                dst = d / f"{f.stem}_{j}.jpg"
                cv2.imwrite(str(dst), im[y1:y2, x1:x2])
            else:
                dst = d / f"{f.stem}_{j}.png"
                write_png(dst, im[y1:y2, x1:x2])
            crops.append(dst)
    print(f"extracted {len(crops)} crops -> {out}")
    return crops


def flatten_recursive(path: str) -> int:
    """Copy every file in a tree into ``<path>_flat``; returns the count."""
    p = Path(path)
    out = Path(str(p) + "_flat")
    out.mkdir(exist_ok=True)
    n = 0
    for f in p.rglob("*"):
        if f.is_file():
            shutil.copy(f, out / f.name)
            n += 1
    print(f"flattened {n} files -> {out}")
    return n


def main(argv=None) -> int:
    logging.basicConfig(format="%(message)s", level=logging.INFO)
    ap = argparse.ArgumentParser(
        "python -m multispectral_object_detection_tpu_torch.tools."
        "dataset_tools")
    ap.add_argument("cmd", choices=["autosplit", "extract-boxes", "flatten"])
    ap.add_argument("--path", required=True)
    ap.add_argument("--weights", type=float, nargs=3, default=(0.9, 0.1, 0.0))
    args = ap.parse_args(argv)
    if args.cmd == "autosplit":
        autosplit(args.path, tuple(args.weights))
    elif args.cmd == "extract-boxes":
        extract_boxes(args.path)
    else:
        flatten_recursive(args.path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
