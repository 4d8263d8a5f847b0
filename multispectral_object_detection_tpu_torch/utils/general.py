"""Helpers of the port's entry points: device selection, image sizes, run
directories, COCO class ids and the native-space box rescale.

The port's own copies of the framework-free helpers of
multispectral_object_detection_tpu/utils/general.py and of
``_rescale_to_native`` (multispectral_object_detection_tpu/train/
evaluator.py), with the same arithmetic.
"""

from __future__ import annotations

import glob
import logging
import math
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
