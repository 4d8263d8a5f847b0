"""Datasets and batches for paired RGB+IR (or single) detection.

The port's counterpart of multispectral_object_detection_tpu/data/
datasets.py; its batches equal the JAX loader's byte for byte (``rgb``,
``ir``, ``targets``, ``tmask``, ``shapes``) where cv2 is importable (the
augmentations' warps and HSV tables; data/augment.py):

- image lists from a directory, a glob-free listing file or one file;
  labels from ``images/`` -> ``labels/`` txt files of the RGB side;
- a corrupt-tolerant scan: image header (PNG and JPEG through
  ``data/imageio``, other formats through PIL) with the EXIF rotation,
  size >= 10 px, label validation; bad pairs are skipped with a warning;
- an optional ``.npz`` scan cache keyed by paths, file sizes and ``nc``
  (the JAX package's key leaves ``nc`` out, so a cache written with
  another ``nc`` is taken there without its class check), and the same
  for label files alone (``load_labels_cached``);
- letterboxed samples, square or in aspect-ratio buckets (``rect``, pad
  0.5 in the evaluation protocol), and static-shape collation: targets
  padded to ``max_labels`` per image with a validity mask;
- training samples (``augment``): a 4-tile mosaic (polygon labels warped
  point by point), mixup of two mosaics for single-stream data, the shared
  affine warp, HSV jitter per modality and shared flips, all drawn from the
  loader's ``random.Random``; a RAM cache of decoded pairs
  (``cache_images``);
- ``collate_quad`` (``--quad``): each group of 4 samples becomes one
  2S canvas, the tiles stitched 2x2 or the first tile upsampled 2x;
- ``get_tile`` / ``collate_tiles`` (``--device-aug``): 4 letterboxed
  tiles per sample for ops/augment_device.py, the partners drawn from the
  loader's generator;
- ``BatchLoader``: batches assembled one ahead on a thread; for training
  shuffled per epoch by ``np.random.default_rng(seed + epoch)``, or drawn
  by class-frequency image weights, with the augmentations' generator
  ``random.Random(seed * 1000003 + epoch)``. Under data parallelism every
  rank draws the same global order and assembles its own rows of each
  batch, its generator offset by the rank.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import queue
import random
import struct
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import native
from .augment import (augment_hsv, letterbox, load_scaled, load_scaled_pair,
                      mosaic4_pair, random_affine_pair)
from .imageio import PNG_SIGNATURE, is_jpeg, jpeg_info, png_size

logger = logging.getLogger(__name__)

IMG_EXTS = {".bmp", ".jpg", ".jpeg", ".png", ".tif", ".tiff", ".webp"}
IMG_FORMATS = {"bmp", "jpg", "jpeg", "png", "tif", "tiff", "dng", "webp",
               "mpo"}
_EXIF_ORIENTATION = 274
STRIDE = 32  # the detector's largest stride: rect canvases are multiples


def list_images(source: str) -> List[str]:
    """Expand a directory (recursively, sorted), a ``.txt`` listing (paths
    relative to its folder) or one image file into image paths."""
    p = Path(source)
    if p.is_dir():
        files = sorted(str(f) for f in p.rglob("*")
                       if f.suffix.lower() in IMG_EXTS)
    elif p.is_file() and p.suffix == ".txt":
        files = []
        for line in p.read_text().splitlines():
            line = line.strip()
            if line:
                q = Path(line)
                files.append(str(q if q.is_absolute() else p.parent / q))
    elif p.is_file():
        files = [str(p)]
    else:
        raise FileNotFoundError(f"dataset source not found: {source}")
    if not files:
        raise FileNotFoundError(f"no images under {source}")
    return files


def image_to_label_path(img_path: str) -> str:
    """.../images/x.ext -> .../labels/x.txt (the last ``images`` folder)."""
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    parts = img_path.rsplit(sa, 1)
    stem = sb.join(parts) if len(parts) == 2 else img_path
    return os.path.splitext(stem)[0] + ".txt"


def segments2boxes(segments) -> np.ndarray:
    """Polygons [(n_i, 2) xy] -> (N, 4) xywh boxes around them."""
    if not len(segments):
        return np.zeros((0, 4), dtype=np.float32)
    b = np.array([[s[:, 0].min(), s[:, 1].min(), s[:, 0].max(),
                   s[:, 1].max()] for s in segments], dtype=np.float32)
    return np.stack([(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2,
                     b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], axis=-1)


def read_label_file(path: str, nc: Optional[int] = None):
    """YOLO txt -> ((n, 5) float32 [cls, x, y, w, h] normalised, a per-row
    list of (k, 2) normalised polygons, empty for a box-format file).

    Rows of more than 8 columns switch the file to polygon format: each
    row's points become their bounding box. Raises on negative values,
    coordinates above 1, duplicate rows or a class >= ``nc``."""
    lab = np.zeros((0, 5), dtype=np.float32)
    segments: List[np.ndarray] = []
    if not os.path.isfile(path):
        return lab, segments
    rows = [ln.split() for ln in Path(path).read_text().strip().splitlines()
            if ln.strip()]
    if any(len(r) > 8 for r in rows):
        classes = np.array([r[0] for r in rows], dtype=np.float32)
        segments = [np.array(r[1:], dtype=np.float32).reshape(-1, 2)
                    for r in rows]
        lab = np.concatenate((classes.reshape(-1, 1),
                              segments2boxes(segments)), 1)
    elif rows:
        if not all(len(r) == 5 for r in rows):
            raise ValueError(f"labels require 5 columns each: {path}")
        lab = np.asarray(rows, dtype=np.float32)
    if len(lab):
        if not (lab >= 0).all():
            raise ValueError(f"negative label values in {path}")
        if not (lab[:, 1:] <= 1).all():
            raise ValueError(f"non-normalized coordinates in {path}")
        if np.unique(lab, axis=0).shape[0] != lab.shape[0]:
            raise ValueError(f"duplicate labels in {path}")
        if nc is not None and not (lab[:, 0] < nc).all():
            raise ValueError(f"label class exceeds nc={nc} in {path}")
    return lab, segments


def _pillow_format(head: bytes) -> Optional[str]:
    """The format of the other files the scan accepts (IMG_FORMATS), by
    signature: BMP, TIFF (and DNG) or WebP; None for anything else."""
    if head[:2] == b"BM":
        return "BMP"
    if head[:4] in (b"II*\0", b"MM\0*"):
        return "TIFF"
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "WebP"
    return None


def image_size(path: str):
    """(width, height, format) of an image file, checked for integrity:
    PNG by its own header and chunk CRCs, JPEG by its markers
    (``imageio.jpeg_info``, what PIL's open reads), other formats by PIL's
    verify. The size is swapped for EXIF orientations 6 and 8 only, as the
    JAX package's ``exif_size`` and the reference do: 5 and 7 transpose the
    image too, and their size is kept unswapped there, so here as well.

    Without Pillow, a BMP, TIFF or WebP file raises ImportError naming its
    format (the JAX scan reads it, so it is not dropped), and a file of any
    other signature is corrupt (ValueError), as it is there."""
    with open(path, "rb") as f:
        head = f.read(12)
    if head[:8] == PNG_SIGNATURE:
        return png_size(path) + ("png",)
    if is_jpeg(head):
        w, h, orientation = jpeg_info(path)[:3]
        return (h, w, "jpeg") if orientation in (6, 8) else (w, h, "jpeg")
    try:
        from PIL import Image
    except ImportError:
        fmt = _pillow_format(head)
        if fmt is None:
            raise ValueError("not a PNG or JPEG file, nor another format "
                             "the scan reads") from None
        raise ImportError(f"{path}: a {fmt} image; the scan reads {fmt} "
                          f"through Pillow, which is not installed (PNG and "
                          f"JPEG are read without it)") from None
    with Image.open(path) as im:
        im.verify()
        w, h = im.size
        try:
            if dict(im._getexif().items()).get(_EXIF_ORIENTATION) in (6, 8):
                w, h = h, w
        except (AttributeError, KeyError, IndexError, TypeError):
            pass  # no EXIF, or none that PIL reads
        return w, h, (im.format or "").lower()


def scan_dataset(img_files: Sequence[str],
                 label_files: Optional[Sequence[str]] = None,
                 nc: Optional[int] = None, *,
                 with_labels: bool = True) -> dict:
    """Check every image and parse its labels, warning about and skipping
    corrupt entries. Returns ``keep`` (n,) bool, ``labels`` and
    ``segments`` (lists over all entries, empty where dropped), ``shapes``
    (n, 2) float64 original (h, w) and ``counters``."""
    if with_labels and label_files is None:
        label_files = [image_to_label_path(p) for p in img_files]
    n = len(img_files)
    keep = np.zeros(n, dtype=bool)
    labels: List[np.ndarray] = []
    segments: List[list] = []
    shapes = np.zeros((n, 2), dtype=np.float64)
    nf = nm = ne = ncorr = 0
    for i, im_file in enumerate(img_files):
        lab = np.zeros((0, 5), dtype=np.float32)
        segs: list = []
        try:
            w, h, fmt = image_size(im_file)
            if not (w > 9 and h > 9):
                raise ValueError(f"image size {(w, h)} <10 pixels")
            if fmt not in IMG_FORMATS:
                raise ValueError(f"invalid image format {fmt}")
            if with_labels:
                if os.path.isfile(label_files[i]):
                    nf += 1
                    lab, segs = read_label_file(label_files[i], nc)
                    ne += not len(lab)
                else:
                    nm += 1
            keep[i] = True
            shapes[i] = (h, w)
        except (OSError, ValueError, SyntaxError, struct.error) as e:
            # SyntaxError: what PIL raises for some damaged files
            ncorr += 1
            lab, segs = np.zeros((0, 5), dtype=np.float32), []
            logger.warning(f"ignoring corrupt image and/or label {im_file}: "
                           f"{e}")
        labels.append(lab)
        segments.append(segs)
    counters = {"found": nf, "missing": nm, "empty": ne, "corrupt": ncorr}
    return {"keep": keep, "labels": labels, "segments": segments,
            "shapes": shapes, "counters": counters}


def _files_hash(paths: Sequence[str], extra: str = "") -> str:
    h = hashlib.md5()
    for p in paths:
        h.update(p.encode())
        try:
            h.update(str(os.path.getsize(p)).encode())
        except OSError:
            pass
    h.update(extra.encode())
    return h.hexdigest()


def _log_scan(c: dict, total: int, cached: bool) -> None:
    msg = (f"dataset scan{' (cached)' if cached else ''}: {c['found']} found, "
           f"{c['missing']} missing, {c['empty']} empty, {c['corrupt']} "
           f"corrupt of {total} images")
    (logger.warning if c["corrupt"] else logger.info)(msg)


def scan_pair_cached(rgb_files: Sequence[str],
                     ir_files: Optional[Sequence[str]] = None,
                     cache_dir: Optional[str] = None,
                     nc: Optional[int] = None) -> dict:
    """``scan_dataset`` over RGB(+IR) pairs, labels from the RGB side; a
    pair is dropped when either image is corrupt. With ``cache_dir`` the
    result is kept in an ``.npz`` keyed by an md5 of the paths, the file
    sizes and ``nc``."""
    label_files = [image_to_label_path(p) for p in rgb_files]
    key = _files_hash(list(rgb_files) + label_files + list(ir_files or []),
                      extra=f"nc={nc}")
    cache_path = None
    if cache_dir:
        cache_path = Path(cache_dir) / f"scan_{key[:16]}.npz"
        if cache_path.is_file():
            z = np.load(cache_path, allow_pickle=True)
            if str(z.get("hash")) == key and "segments" in z.files:
                res = {"keep": z["keep"], "labels": list(z["labels"]),
                       "segments": [list(sg) for sg in z["segments"]],
                       "shapes": z["shapes"],
                       "counters": json.loads(str(z["counters"]))}
                _log_scan(res["counters"], len(rgb_files), cached=True)
                return res
    res = scan_dataset(rgb_files, label_files, nc)
    if ir_files is not None:
        ir_scan = scan_dataset(ir_files, with_labels=False)
        res["keep"] &= ir_scan["keep"]
        res["counters"]["corrupt"] += int(ir_scan["counters"]["corrupt"])
    _log_scan(res["counters"], len(rgb_files), cached=False)
    if cache_path is not None:
        cache_path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(cache_path, hash=key, keep=res["keep"],
                 labels=_object_array(res["labels"]),
                 segments=_object_array(res["segments"]),
                 shapes=res["shapes"],
                 counters=json.dumps(res["counters"]))
    return res


def _object_array(items: list) -> np.ndarray:
    """A 1-D object array of ``items`` (np.asarray would stack equal
    shapes into one array)."""
    arr = np.empty(len(items), dtype=object)
    for i, x in enumerate(items):
        arr[i] = x
    return arr


def load_labels_cached(img_files: Sequence[str],
                       cache_dir: Optional[str] = None,
                       nc: Optional[int] = None) -> List[np.ndarray]:
    """The (n, 5) float32 label array of each image (``read_label_file``;
    empty where the file is missing). With ``cache_dir`` they are kept in
    an ``.npz`` keyed by an md5 of the image and label paths, their file
    sizes and ``nc``, and read from it while the key holds."""
    label_files = [image_to_label_path(p) for p in img_files]
    key = _files_hash(list(img_files) + label_files, extra=f"nc={nc}")
    cache_path = None
    if cache_dir:
        cache_path = Path(cache_dir) / f"labels_{key[:16]}.npz"
        if cache_path.is_file():
            z = np.load(cache_path, allow_pickle=True)
            if str(z.get("hash")) == key:
                return list(z["labels"])
    labels = [read_label_file(p, nc)[0] for p in label_files]
    if cache_path is not None:
        cache_path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(cache_path, hash=key, labels=_object_array(labels))
    return labels


class PairedDetectionDataset:
    """Paired RGB+IR (or RGB only, ``ir_files`` None) images.

    ``get(i, rng)`` returns (rgb (h, w, 3) uint8, ir or None, labels (n, 5)
    [cls, x, y, w, h] normalised to the output canvas, shape_info
    ((h0, w0), ((rw, rh), (dw, dh))) for the rescale to native pixels).
    Evaluation samples (``augment`` false) are letterboxed and never scaled
    up; training samples are augmented with ``hyp`` from ``rng``. Rect
    training (``rect`` with ``augment``) keeps the affine warp and HSV but
    no mosaic."""

    def __init__(self, rgb_files: Sequence[str],
                 ir_files: Optional[Sequence[str]] = None, *,
                 img_size: int = 640, nc: Optional[int] = None,
                 cache_dir: Optional[str] = None, pad: float = 0.0,
                 rect: bool = False, augment: bool = False,
                 hyp: Optional[dict] = None, cache_images: bool = False):
        self.rgb_files = list(rgb_files)
        self.ir_files = list(ir_files) if ir_files is not None else None
        if self.ir_files is not None and \
                len(self.ir_files) != len(self.rgb_files):
            raise ValueError("RGB/IR list length mismatch")
        self.img_size = img_size
        scan = scan_pair_cached(self.rgb_files, self.ir_files, cache_dir, nc)
        kept = [i for i in range(len(self.rgb_files)) if scan["keep"][i]]
        if not kept:
            raise ValueError("dataset scan dropped every image as corrupt")
        self.rgb_files = [self.rgb_files[i] for i in kept]
        if self.ir_files is not None:
            self.ir_files = [self.ir_files[i] for i in kept]
        self.labels = [scan["labels"][i] for i in kept]
        self.segments = [scan["segments"][i] for i in kept]
        self.shapes = scan["shapes"][kept]
        self.augment = augment
        self.hyp = dict(hyp or {})
        # decoded, scaled pairs by index, filled lazily
        self.cache_images = cache_images
        self._img_cache: Dict[int, tuple] = {}
        self.scan_counters = scan["counters"]
        self.pad = pad
        self.rect = bool(rect)
        self.rect_order = None   # image order sorted by aspect ratio
        self.rect_shape = None   # index -> its batch's (h, w) canvas
        if self.rect:
            self._setup_rect()

    def _setup_rect(self, batch_size: int = 32) -> None:
        """Aspect-ratio buckets: images sorted by h/w; each batch's canvas
        is the smallest stride multiple (plus ``pad`` strides) that covers
        its range of aspect ratios."""
        s = np.asarray(self.shapes, dtype=np.float64)
        ar = s[:, 0] / s[:, 1]
        order = np.argsort(ar)
        nb = -(-len(order) // batch_size)
        shapes = np.ones((nb, 2))
        for b in range(nb):
            ari = ar[order[b * batch_size:(b + 1) * batch_size]]
            mini, maxi = ari.min(), ari.max()
            if maxi < 1:
                shapes[b] = [maxi, 1.0]
            elif mini > 1:
                shapes[b] = [1.0, 1.0 / mini]
        canvas = np.ceil(shapes * self.img_size / STRIDE
                         + self.pad).astype(int) * STRIDE
        self.rect_order = order
        self.rect_shape = {
            int(i): (int(canvas[b, 0]), int(canvas[b, 1]))
            for b in range(nb)
            for i in order[b * batch_size:(b + 1) * batch_size]}

    def __len__(self):
        return len(self.rgb_files)

    @classmethod
    def from_sources(cls, rgb_source: str, ir_source: Optional[str] = None,
                     **kw) -> "PairedDetectionDataset":
        rgb = list_images(rgb_source)
        ir = list_images(ir_source) if ir_source else None
        if ir is not None and len(ir) != len(rgb):
            raise ValueError(f"paired datasets must align: {len(rgb)} RGB "
                             f"vs {len(ir)} IR")
        return cls(rgb, ir, **kw)

    def _load_pair(self, i: int):
        if i in self._img_cache:
            return self._img_cache[i]
        if self.ir_files is None:
            rgb, hw0 = load_scaled(self.rgb_files[i], self.img_size)
            out = rgb, rgb, hw0
        else:
            out = load_scaled_pair(self.rgb_files[i], self.ir_files[i],
                                   self.img_size)
        if self.cache_images:
            self._img_cache[i] = out
        return out

    def _tile(self, i: int):
        """A mosaic tile: (rgb, ir, labels, polygons)."""
        rgb, ir, _ = self._load_pair(i)
        return rgb, ir, self.labels[i], self.segments[i]

    def get_tile(self, i: int):
        """A tile of the device-side augmentation: the pair letterboxed to
        s x s (scaled up if smaller), labels renormalised to the tile; no
        random draws."""
        s = self.img_size
        rgb0, ir0, _ = self._load_pair(i)
        lab = self.labels[i]
        h, w = rgb0.shape[:2]
        rgb, ratio, padwh = letterbox(rgb0, (s, s), scaleup=True)
        ir, _, _ = letterbox(ir0, (s, s), scaleup=True)
        out = np.zeros_like(lab)
        if len(lab):
            out[:, 0] = lab[:, 0]
            out[:, 1] = (ratio[0] * w * lab[:, 1] + padwh[0]) / s
            out[:, 2] = (ratio[1] * h * lab[:, 2] + padwh[1]) / s
            out[:, 3] = ratio[0] * w * lab[:, 3] / s
            out[:, 4] = ratio[1] * h * lab[:, 4] / s
        return np.ascontiguousarray(rgb), np.ascontiguousarray(ir), out

    def get(self, i: int, rng: Optional[random.Random] = None):
        if self.augment:
            return self._get_augmented(i, rng or random.Random())
        rgb0, ir0, hw0 = self._load_pair(i)
        lab = self.labels[i]
        h, w = rgb0.shape[:2]
        canvas = self.rect_shape[int(i)] if self.rect else \
            (self.img_size, self.img_size)
        # evaluation never scales an image up (the JAX package's
        # scaleup_eval, off in its CLI)
        rgb, ratio, padwh = letterbox(rgb0, canvas, scaleup=False)
        ir, _, _ = letterbox(ir0, canvas, scaleup=False)
        lab_xyxy = lab.copy()
        if lab.size:
            lab_xyxy[:, 1] = ratio[0] * w * (lab[:, 1] - lab[:, 3] / 2) + padwh[0]
            lab_xyxy[:, 2] = ratio[1] * h * (lab[:, 2] - lab[:, 4] / 2) + padwh[1]
            lab_xyxy[:, 3] = ratio[0] * w * (lab[:, 1] + lab[:, 3] / 2) + padwh[0]
            lab_xyxy[:, 4] = ratio[1] * h * (lab[:, 2] + lab[:, 4] / 2) + padwh[1]
        hh, ww = rgb.shape[:2]
        labels = np.zeros((len(lab_xyxy), 5), dtype=np.float32)
        if len(lab_xyxy):
            labels[:, 0] = lab_xyxy[:, 0]
            labels[:, 1] = ((lab_xyxy[:, 1] + lab_xyxy[:, 3]) / 2) / ww
            labels[:, 2] = ((lab_xyxy[:, 2] + lab_xyxy[:, 4]) / 2) / hh
            labels[:, 3] = (lab_xyxy[:, 3] - lab_xyxy[:, 1]) / ww
            labels[:, 4] = (lab_xyxy[:, 4] - lab_xyxy[:, 2]) / hh
        return (rgb, ir if self.ir_files is not None else None, labels,
                (hw0, (ratio, padwh)))


    def _get_augmented(self, i: int, rng: random.Random):
        hyp, s = self.hyp, self.img_size
        if not self.rect and rng.random() < hyp.get("mosaic", 1.0):
            idxs = [i] + [rng.randint(0, len(self) - 1) for _ in range(3)]
            rgb, ir, lab_xyxy = mosaic4_pair(self._tile, idxs, s, hyp, rng)
            # mixup of two mosaics, single-stream only (the reference
            # disables it for two modalities)
            if self.ir_files is None and rng.random() < hyp.get("mixup", 0.0):
                idxs2 = [rng.randint(0, len(self) - 1) for _ in range(4)]
                rgb2, _, lab2 = mosaic4_pair(self._tile, idxs2, s, hyp, rng)
                r = rng.betavariate(32.0, 32.0)
                rgb = (rgb.astype(np.float32) * r
                       + rgb2.astype(np.float32) * (1 - r)).astype(np.uint8)
                ir = rgb
                lab_xyxy = np.concatenate([lab_xyxy, lab2], 0)
            shape_info = ((s, s), ((1.0, 1.0), (0.0, 0.0)))
        else:
            # polygons are mosaic-only, as in the reference
            rgb0, ir0, hw0 = self._load_pair(i)
            lab = self.labels[i]
            h, w = rgb0.shape[:2]
            canvas = self.rect_shape[int(i)] if self.rect else (s, s)
            rgb, ratio, padwh = letterbox(rgb0, canvas, scaleup=True)
            ir, _, _ = letterbox(ir0, canvas, scaleup=True)
            lab_xyxy = lab.copy()
            if lab.size:
                lab_xyxy[:, 1] = ratio[0] * w * (lab[:, 1] - lab[:, 3] / 2) \
                    + padwh[0]
                lab_xyxy[:, 2] = ratio[1] * h * (lab[:, 2] - lab[:, 4] / 2) \
                    + padwh[1]
                lab_xyxy[:, 3] = ratio[0] * w * (lab[:, 1] + lab[:, 3] / 2) \
                    + padwh[0]
                lab_xyxy[:, 4] = ratio[1] * h * (lab[:, 2] + lab[:, 4] / 2) \
                    + padwh[1]
            rgb, ir, lab_xyxy = random_affine_pair(
                rgb, ir, lab_xyxy, degrees=hyp.get("degrees", 0.0),
                translate=hyp.get("translate", 0.1),
                scale=hyp.get("scale", 0.5), shear=hyp.get("shear", 0.0),
                perspective=hyp.get("perspective", 0.0), rng=rng)
            shape_info = (hw0, (ratio, padwh))
        gains = (hyp.get("hsv_h", 0.015), hyp.get("hsv_s", 0.7),
                 hyp.get("hsv_v", 0.4))
        rgb = augment_hsv(rgb, *gains, rng=rng)  # drawn per modality
        if self.ir_files is not None:
            ir = augment_hsv(ir, *gains, rng=rng)
        hh, ww = rgb.shape[:2]
        labels = np.zeros((len(lab_xyxy), 5), dtype=np.float32)
        if len(lab_xyxy):
            labels[:, 0] = lab_xyxy[:, 0]
            labels[:, 1] = ((lab_xyxy[:, 1] + lab_xyxy[:, 3]) / 2) / ww
            labels[:, 2] = ((lab_xyxy[:, 2] + lab_xyxy[:, 4]) / 2) / hh
            labels[:, 3] = (lab_xyxy[:, 3] - lab_xyxy[:, 1]) / ww
            labels[:, 4] = (lab_xyxy[:, 4] - lab_xyxy[:, 2]) / hh
        # flips shared by both modalities
        if rng.random() < hyp.get("flipud", 0.0):
            rgb, ir = np.flipud(rgb), np.flipud(ir)
            if len(labels):
                labels[:, 2] = 1.0 - labels[:, 2]
        if rng.random() < hyp.get("fliplr", 0.5):
            rgb, ir = np.fliplr(rgb), np.fliplr(ir)
            if len(labels):
                labels[:, 1] = 1.0 - labels[:, 1]
        return (np.ascontiguousarray(rgb),
                np.ascontiguousarray(ir) if self.ir_files is not None
                else None, labels, shape_info)


def collate_batch(samples, indices, max_labels: int = 120) -> dict:
    """Stack samples into static shapes: ``rgb`` (B, h, w, 3) uint8,
    ``ir`` likewise (absent for single-stream data), ``targets``
    (B * max_labels, 6) [img, cls, x, y, w, h], ``tmask`` (B *
    max_labels,) float32, ``shapes`` (the samples' shape_info) and
    ``index`` (B,) int64, the samples' ``indices`` in the dataset (rect
    batches follow the aspect order, not the file order)."""
    rgbs, irs, ts, ms, shapes = [], [], [], [], []
    for bi, (rgb, ir, labels, shape_info) in enumerate(samples):
        rgbs.append(rgb)
        if ir is not None:
            irs.append(ir)
        t = np.zeros((max_labels, 6), dtype=np.float32)
        n = min(len(labels), max_labels)
        if n:
            t[:n, 0] = bi
            t[:n, 1:] = labels[:n]
        m = np.zeros((max_labels,), dtype=np.float32)
        m[:n] = 1.0
        ts.append(t)
        ms.append(m)
        shapes.append(shape_info)
    out = {"rgb": np.stack(rgbs), "targets": np.concatenate(ts, 0),
           "tmask": np.concatenate(ms, 0), "shapes": shapes,
           "index": np.asarray(indices, np.int64)}
    if irs:
        out["ir"] = np.stack(irs)
    return out


def collate_quad(samples, indices, max_labels: int = 120,
                 rng: Optional[random.Random] = None) -> dict:
    """``--quad`` batches (the reference's collate_fn4): each group of 4
    samples becomes one image on a 2S canvas, with probability 0.5 the
    first sample upsampled 2x (INTER_LINEAR, the C++ runtime), else the
    four stitched 2x2: sample i top-left, i+1 bottom-left, i+2 top-right,
    i+3 bottom-right, labels halved. (B/4, 2S, 2S, 3) images, targets
    (B/4 * 4 * max_labels, 6); the trainer scales the loss by 4."""
    if len(samples) % 4:
        raise ValueError("--quad needs a batch divisible by 4")
    rng = rng or random.Random(0)
    s = samples[0][0].shape[0]
    two = samples[0][1] is not None
    ml4 = 4 * max_labels
    rgbs, irs, ts, ms, shapes = [], [], [], [], []
    offs = ((0.0, 0.0), (0.0, 1.0), (1.0, 0.0), (1.0, 1.0))  # (x, y) offset
    for g in range(len(samples) // 4):
        group = samples[g * 4:(g + 1) * 4]
        labs = []
        if rng.random() < 0.5:
            rgb = native.resize(group[0][0], 2 * s, 2 * s)
            ir = native.resize(group[0][1], 2 * s, 2 * s) if two else None
            if len(group[0][2]):
                labs.append(group[0][2])  # normalised: scale-free
        else:
            rgb = np.zeros((2 * s, 2 * s, 3), np.uint8)
            ir = np.zeros((2 * s, 2 * s, 3), np.uint8) if two else None
            for (xo, yo), (r, q, lab, _) in zip(offs, group):
                y0, x0 = int(yo * s), int(xo * s)
                rgb[y0:y0 + s, x0:x0 + s] = r
                if two:
                    ir[y0:y0 + s, x0:x0 + s] = q
                if len(lab):
                    lab = lab.copy()
                    lab[:, 1] = (lab[:, 1] + xo) * 0.5
                    lab[:, 2] = (lab[:, 2] + yo) * 0.5
                    lab[:, 3:5] *= 0.5
                    labs.append(lab)
        labels = np.concatenate(labs, 0) if labs else \
            np.zeros((0, 5), np.float32)
        t = np.zeros((ml4, 6), dtype=np.float32)
        m = np.zeros((ml4,), dtype=np.float32)
        n = min(len(labels), ml4)
        if n:
            t[:n, 0] = g
            t[:n, 1:] = labels[:n]
            m[:n] = 1.0
        rgbs.append(rgb)
        if two:
            irs.append(ir)
        ts.append(t)
        ms.append(m)
        shapes.append(group[0][3])
    out = {"rgb": np.stack(rgbs), "targets": np.concatenate(ts, 0),
           "tmask": np.concatenate(ms, 0), "shapes": shapes,
           "index": np.asarray(indices, np.int64)[::4]}
    if irs:
        out["ir"] = np.stack(irs)
    return out


def collate_tiles(ds: PairedDetectionDataset, batch_idx, rng: random.Random,
                  max_labels_per_tile: int = 40) -> dict:
    """A ``--device-aug`` batch: per sample its own tile and 3 partners
    drawn from ``rng`` (as the mosaic draws them), letterboxed:
    ``tiles_rgb``/``tiles_ir`` (B, 4, s, s, 3) uint8, ``tile_labels``
    (B, 4, M, 5) and ``tile_lmask`` (B, 4, M), M = max_labels_per_tile."""
    B, s, M = len(batch_idx), ds.img_size, max_labels_per_tile
    rgb = np.zeros((B, 4, s, s, 3), np.uint8)
    ir = np.zeros((B, 4, s, s, 3), np.uint8)
    labels = np.zeros((B, 4, M, 5), np.float32)
    lmask = np.zeros((B, 4, M), np.float32)
    for bi, i in enumerate(batch_idx):
        idxs = [int(i)] + [rng.randint(0, len(ds) - 1) for _ in range(3)]
        for ti, j in enumerate(idxs):
            r, q, lab = ds.get_tile(j)
            rgb[bi, ti] = r
            ir[bi, ti] = q
            n = min(len(lab), M)
            labels[bi, ti, :n] = lab[:n]
            lmask[bi, ti, :n] = 1.0
    return {"tiles_rgb": rgb, "tiles_ir": ir, "tile_labels": labels,
            "tile_lmask": lmask, "index": np.asarray(batch_idx, np.int64)}


class BatchLoader:
    """The batches of one epoch, each assembled while the previous one is
    consumed.

    By default all of them in order (rect datasets: in aspect-ratio order;
    the last batch may be short). ``shuffle`` permutes the images with
    ``np.random.default_rng(seed + epoch)``; ``image_weights`` draws them
    with replacement by class-frequency weights instead; ``drop_last``
    drops a short last batch. Augmented samples draw from
    ``random.Random(seed * 1000003 + epoch)``. ``epoch`` counts the
    completed passes (a resumed run sets it).

    ``device_aug`` yields ``collate_tiles`` batches, ``quad``
    ``collate_quad`` batches (exclusive). With ``rank``/``world`` (the
    data-parallel grid) ``batch_size`` is the global batch: every rank
    draws the same order and assembles rows [rank * b, (rank + 1) * b) of
    each batch, b = batch_size / world, its generator's seed offset by
    ``rank << 32`` (rank 0 draws as one process does)."""

    def __init__(self, dataset: PairedDetectionDataset, batch_size: int, *,
                 max_labels: int = 120, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, image_weights: bool = False,
                 class_weights=None, device_aug: bool = False,
                 max_labels_per_tile: int = 40, quad: bool = False,
                 rank: int = 0, world: int = 1):
        if quad and device_aug:
            raise ValueError("--quad and --device-aug are exclusive")
        if batch_size % world or (quad and (batch_size // world) % 4):
            raise ValueError(f"batch {batch_size} does not split into "
                             f"{world} ranks{' of multiples of 4' if quad else ''}")
        self.ds = dataset
        self.bs = batch_size
        self.device_aug = device_aug
        self.max_labels_per_tile = max_labels_per_tile
        self.quad = quad
        self.rank, self.world = rank, world
        self.max_labels = max_labels
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.image_weights = image_weights
        self.class_weights = class_weights
        self.epoch = 0
        if dataset.rect:
            dataset._setup_rect(batch_size)  # buckets follow the batches

    def __len__(self):
        n = len(self.ds)
        return n // self.bs if self.drop_last else -(-n // self.bs)

    def _indices(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed + self.epoch)
        if self.ds.rect:
            return np.asarray(self.ds.rect_order)
        if self.image_weights:
            from ..utils.general import (labels_to_class_weights,
                                         labels_to_image_weights)

            nc = int(max((lab[:, 0].max() for lab in self.ds.labels
                          if len(lab)), default=0)) + 1
            cw = (self.class_weights if self.class_weights is not None
                  else labels_to_class_weights(self.ds.labels, nc))
            iw = labels_to_image_weights(self.ds.labels, nc, cw)
            p = iw / iw.sum() if iw.sum() > 0 else None
            return rng.choice(len(self.ds), size=len(self.ds), p=p)
        idx = np.arange(len(self.ds))
        if self.shuffle:
            rng.shuffle(idx)
        return idx

    def _batches(self):
        idx = self._indices()
        b = self.bs // self.world
        return [idx[k * self.bs:(k + 1) * self.bs][self.rank * b:
                                                   (self.rank + 1) * b]
                for k in range(len(self))]

    def _assemble(self, batch_idx, rng: random.Random) -> dict:
        if self.device_aug:
            return collate_tiles(self.ds, batch_idx, rng,
                                 self.max_labels_per_tile)
        samples = [self.ds.get(int(i), rng) for i in batch_idx]
        if self.quad:
            return collate_quad(samples, batch_idx, self.max_labels, rng)
        return collate_batch(samples, batch_idx, self.max_labels)

    def __iter__(self):
        batches = self._batches()
        rng = random.Random(self.seed * 1000003 + self.epoch
                            + (self.rank << 32))
        q: "queue.Queue" = queue.Queue(maxsize=2)
        stop = threading.Event()

        def worker():
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    q.put(("batch", self._assemble(b, rng)))
                q.put(("end", None))
            except BaseException as e:  # handed to the consumer, re-raised
                q.put(("error", e))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                kind, item = q.get()
                if kind == "end":
                    self.epoch += 1
                    return
                if kind == "error":
                    raise item
                yield item
        finally:
            stop.set()
            while t.is_alive():  # unblock a worker waiting on a full queue
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()
