"""Helpers of the port's entry points: device selection, seeds, image
sizes, run directories and the newest ``last`` checkpoint, class and image
weights, COCO class ids, the native-space box rescale, box drawing, image
writing and detection crops; file and dataset checks, coloured log text,
importable packages and the checkout's git status.

The port's own copies of the framework-free helpers of
multispectral_object_detection_tpu/utils/general.py and of
``_rescale_to_native`` (multispectral_object_detection_tpu/train/
evaluator.py), with the same arithmetic. Drawing and writing use cv2 where
it is importable, as the JAX package does (boxes with labels, JPEG files).
Without cv2 the boxes are numpy rectangles without labels (cv2.rectangle's
pixels but for the rounded outer corners of lines thicker than 1) and the
files are PNG (``data/imageio.write_png``); the first such call logs it.
"""

from __future__ import annotations

import glob
import logging
import math
import os
import random
import re
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger(__name__)


def select_device(device=None) -> torch.device:
    """The torch device for an entry point: ``None`` means ``"cuda"``.

    Raises when CUDA is asked for (explicitly or by default) and absent; the
    CPU is used only when the caller passes ``"cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run "
                           "on the CPU")
    return dev


def device_from_arg(arg: str) -> torch.device:
    """A CLI's ``--device``: '' = CUDA (raises without a GPU), 'cpu',
    'cuda:N' or a CUDA index N."""
    arg = (arg or "").strip()
    return select_device(f"cuda:{arg}" if arg.isdigit() else (arg or None))


def init_seeds(seed: int = 0) -> None:
    """Seed Python's, numpy's and torch's global generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def get_latest_run(search_dir: str = ".") -> str:
    """The newest ``last`` checkpoint directory (or ``last.ckpt*`` file)
    under ``search_dir``, for a bare ``--resume``; '' when there is none."""
    paths = glob.glob(f"{search_dir}/**/last.ckpt*", recursive=True) + \
        glob.glob(f"{search_dir}/**/last", recursive=True)
    return max(paths, key=os.path.getctime) if paths else ""


def labels_to_class_weights(labels, nc: int) -> np.ndarray:
    """Inverse class frequencies over all label rows, normalised to sum 1
    (a class without labels counts once)."""
    if not len(labels):
        return np.ones(nc)
    cls = np.concatenate([lab[:, 0] for lab in labels if len(lab)],
                         0).astype(int) \
        if any(len(lab) for lab in labels) else np.zeros(0, int)
    weights = np.bincount(cls, minlength=nc).astype(float)
    weights[weights == 0] = 1.0
    weights = 1.0 / weights
    return weights / weights.sum()


def labels_to_image_weights(labels, nc: int,
                            class_weights=None) -> np.ndarray:
    """Per image: the sum over its label rows of their class weights."""
    cw = class_weights if class_weights is not None else np.ones(nc)
    counts = np.array([np.bincount(lab[:, 0].astype(int), minlength=nc)
                       if len(lab) else np.zeros(nc) for lab in labels])
    return (counts * cw.reshape(1, nc)).sum(1)


def check_img_size(img_size: int, stride: int = 32) -> int:
    """Round an image size up to a multiple of ``stride``."""
    new = int(math.ceil(img_size / stride) * stride)
    if new != img_size:
        logger.warning(f"--img-size {img_size} must be a multiple of "
                       f"{stride}; using {new}")
    return new


def increment_path(path, exist_ok: bool = False) -> Path:
    """runs/test/exp -> exp2, exp3, ... when ``path`` exists (and
    ``exist_ok`` is false)."""
    path = Path(path)
    if not path.exists() or exist_ok:
        return path
    matches = [re.search(r"%s(\d+)" % re.escape(path.stem), d)
               for d in glob.glob(f"{path}*")]
    idx = [int(m.groups()[0]) for m in matches if m]
    return Path(f"{path}{max(idx) + 1 if idx else 2}")


def coco80_to_coco91_class() -> list:
    """80-index -> 91-index COCO category ids."""
    return [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20,
            21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
            41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
            59, 60, 61, 62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79,
            80, 81, 82, 84, 85, 86, 87, 88, 89, 90]


def rescale_to_native(boxes: np.ndarray, canvas_hw, native_hw,
                      ratio_pad) -> np.ndarray:
    """xyxy boxes on the letterboxed canvas -> the native image, clipped.

    ratio_pad: ((gain, gain), (padw, padh)) as the loader recorded it, or
    None to derive both from the two shapes."""
    if ratio_pad is None:
        gain = min(canvas_hw[0] / native_hw[0], canvas_hw[1] / native_hw[1])
        padw = (canvas_hw[1] - native_hw[1] * gain) / 2
        padh = (canvas_hw[0] - native_hw[0] * gain) / 2
    else:
        gain = ratio_pad[0][0]
        padw, padh = ratio_pad[1]
    out = boxes.copy()
    out[:, [0, 2]] = (out[:, [0, 2]] - padw) / gain
    out[:, [1, 3]] = (out[:, [1, 3]] - padh) / gain
    out[:, [0, 2]] = out[:, [0, 2]].clip(0, native_hw[1])
    out[:, [1, 3]] = out[:, [1, 3]].clip(0, native_hw[0])
    return out


_NO_CV2_NOTED = False


def _cv2():
    """cv2 where it is importable, else None (noted once in the log)."""
    global _NO_CV2_NOTED
    try:
        import cv2
        return cv2
    except ImportError:
        if not _NO_CV2_NOTED:
            _NO_CV2_NOTED = True
            logger.info("cv2 is not installed: boxes are drawn without "
                        "labels, images are written as PNG, and training "
                        "warps and HSV jitter run in the port's C++ "
                        "runtime")
        return None


def _rectangle(img: np.ndarray, p1, p2, color, thickness: int) -> None:
    """cv2.rectangle's outline in numpy: a band of +-(t+1)//2 pixels about
    each edge (the edge itself for t = 1), square where cv2 rounds the
    outer corners."""
    (x1, x2), (y1, y2) = sorted((p1[0], p2[0])), sorted((p1[1], p2[1]))
    h, w = img.shape[:2]
    a = 0 if thickness <= 1 else (thickness + 1) // 2
    for ya, yb, xa, xb in ((y1 - a, y1 + a, x1 - a, x2 + a),
                           (y2 - a, y2 + a, x1 - a, x2 + a),
                           (y1 - a, y2 + a, x1 - a, x1 + a),
                           (y1 - a, y2 + a, x2 - a, x2 + a)):
        ya, yb, xa, xb = max(ya, 0), min(yb, h - 1), max(xa, 0), min(xb, w - 1)
        if ya <= yb and xa <= xb:
            img[ya:yb + 1, xa:xb + 1] = color


def draw_box(img: np.ndarray, xyxy, color, thickness: int = 2,
             label=None) -> None:
    """Draw a box (and with cv2 its label above it, cv2.FONT_HERSHEY_SIMPLEX
    at 0.6) on an HWC uint8 image in place, in the image's channel order."""
    p1, p2 = (int(xyxy[0]), int(xyxy[1])), (int(xyxy[2]), int(xyxy[3]))
    cv2 = _cv2()
    if cv2 is None:
        _rectangle(img, p1, p2, color, thickness)
        return
    cv2.rectangle(img, p1, p2, color, thickness)
    if label:
        cv2.putText(img, label, (p1[0], p1[1] - 4), cv2.FONT_HERSHEY_SIMPLEX,
                    0.6, color, thickness)


def write_image(path, img_rgb: np.ndarray) -> Path:
    """Write an RGB image: JPEG at ``path`` through cv2, else PNG beside it
    (same stem). Returns the path written."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    cv2 = _cv2()
    if cv2 is None:
        from ..data.imageio import write_png

        path = path.with_suffix(".png")
        write_png(path, img_rgb)
    else:
        cv2.imwrite(str(path), np.ascontiguousarray(img_rgb[..., ::-1]))
    return path


def save_one_box(xyxy, im: np.ndarray, file="image.jpg", gain: float = 1.02,
                 pad: int = 10, square: bool = False, bgr: bool = False,
                 save: bool = True) -> np.ndarray:
    """Crop a detection from ``im`` (HWC RGB; BGR when ``bgr``) with the
    reference's margin rule (general.py:628-640): box wh * gain + pad px,
    optionally square. Returns the crop; writes it (``write_image``) when
    ``save``."""
    x1, y1, x2, y2 = [float(v) for v in xyxy]
    cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
    w, h = x2 - x1, y2 - y1
    if square:
        w = h = max(w, h)
    w, h = w * gain + pad, h * gain + pad
    x1, x2 = int(cx - w / 2), int(cx + w / 2)
    y1, y2 = int(cy - h / 2), int(cy + h / 2)
    x1, x2 = max(x1, 0), min(x2, im.shape[1])
    y1, y2 = max(y1, 0), min(y2, im.shape[0])
    crop = im[y1:y2, x1:x2]
    if save and crop.size:
        write_image(Path(file).with_suffix(".jpg"),
                    crop[..., ::-1] if bgr else crop)
    return crop


def colorstr(*inputs):
    """ANSI-colored string (general.py:225)."""
    *args, string = inputs if len(inputs) > 1 else ("blue", "bold", inputs[0])
    colors = {
        "black": "\033[30m", "red": "\033[31m", "green": "\033[32m",
        "yellow": "\033[33m", "blue": "\033[34m", "magenta": "\033[35m",
        "cyan": "\033[36m", "white": "\033[37m", "bright_red": "\033[91m",
        "bright_green": "\033[92m", "bright_yellow": "\033[93m",
        "end": "\033[0m", "bold": "\033[1m", "underline": "\033[4m",
    }
    return "".join(colors[x] for x in args) + f"{string}" + colors["end"]


def check_file(file: str) -> str:
    """Return `file` if it exists, else search for it recursively
    (general.py:152-161)."""
    if file == "" or Path(file).is_file():
        return file
    files = glob.glob("./**/" + str(file), recursive=True)
    assert len(files), f"File Not Found: {file}"
    assert len(files) == 1, \
        f"Multiple files match '{file}', specify exact path: {files}"
    return files[0]


def check_dataset(data: dict, autodownload: bool = True):
    """Verify the dataset's val paths exist; attempt the YAML's `download`
    recipe if not (general.py:163-183). Handles both the single-stream
    (`val`) and two-stream (`val_rgb`/`val_ir`) key planes.

    Without network access the download fails and the error names the
    missing paths and the recipe.
    """
    import subprocess

    vals = []
    for key in ("val", "val_rgb", "val_ir"):
        v = data.get(key)
        if v:
            vals += v if isinstance(v, list) else [v]
    if not vals:
        return
    missing = [str(Path(x).resolve()) for x in vals
               if not Path(x).exists()]
    if not missing:
        return
    logging.warning(f"Dataset not found, nonexistent paths: {missing}")
    s = data.get("download")
    if not (s and autodownload):
        raise FileNotFoundError(f"Dataset not found: {missing}")
    if str(s).startswith("http") and str(s).endswith(".zip"):
        import urllib.request

        f = Path(str(s)).name
        logging.info(f"Downloading {s} ...")
        urllib.request.urlretrieve(str(s), f)
        r = subprocess.run(["unzip", "-q", f, "-d", ".."]).returncode
        Path(f).unlink(missing_ok=True)
    elif str(s).startswith("bash "):
        logging.info(f"Running {s} ...")
        r = subprocess.run(str(s), shell=True).returncode
    else:
        exec(str(s))
        r = 0
    if r != 0:
        raise RuntimeError(f"dataset autodownload failed (rc={r})")
    still = [x for x in missing if not Path(x).exists()]
    if still:
        raise FileNotFoundError(f"Dataset still missing after download: "
                                f"{still}")


def check_requirements(requirements=("torch", "numpy"), exclude=()):
    """Report which of ``requirements`` do not import (general.py:101-127);
    the reference installs them with pip, this never installs anything."""
    import importlib

    missing = []
    for r in requirements:
        if r in exclude:
            continue
        try:
            importlib.import_module(r)
        except ImportError:
            missing.append(r)
    if missing:
        logging.warning(f"check_requirements: missing packages {missing} "
                        f"(no auto-install in this environment)")
    return missing


def check_git_status(repo_dir: str = "."):
    """Warn if the local git checkout is behind its remote, as the last
    fetch recorded it (general.py:79-98); reads local status only."""
    import subprocess

    try:
        out = subprocess.run(["git", "-C", str(repo_dir), "status",
                              "--porcelain", "-b"], capture_output=True,
                             text=True, timeout=10)
        head = out.stdout.splitlines()[0] if out.stdout else ""
        if "behind" in head:
            logging.warning(f"check_git_status: {head} — "
                            f"`git pull` to update")
        return head
    except Exception as e:  # no git / not a repo
        logging.info(f"check_git_status skipped: {e}")
        return ""
