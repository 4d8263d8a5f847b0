"""Model factory, ensembles and the detector.

Counterparts of multispectral_object_detection_tpu/hub.py: ``create``
builds a named config with random weights or a checkpoint's, in its
inference form; ``DetectionResults`` holds ragged per-image results;
``Ensemble`` combines several checkpoints' decoded outputs; ``Detector``
serves. ``Detector.__call__`` takes image paths or HWC arrays of any size,
letterboxes them on the host (``data/augment.letterbox``), runs
``Detector.infer`` and rescales the boxes to native pixels.
``Detector.infer`` is the serving core that bench.py times (the JAX
``Detector._compile``'s ``infer``): uint8 batches at the canvas size /
255 -> BN-folded forward in the compute dtype (the CFT stacks through the
CUDA kernels) -> decode -> batched NMS.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .data.augment import letterbox
from .data.imageio import imread
from .models.configs import get_config
from .models.model import (build_model, cast_inference_params, init_weights,
                           load_reference_state_dict)
from .models.quantize import quantize_int8
from .ops.nms import Detections, batched_nms
from .train.eval_forward import ENSEMBLE_MODES, combine_members
from .utils.checkpoint import load_inference_params
from .utils.general import draw_box, select_device, write_image


def create(cfg: Union[str, dict] = "yolov5l_fusion_transformerx3",
           nc: Optional[int] = None, weights=None, state_dict=None,
           dtype: torch.dtype = torch.bfloat16, device=None,
           fuse: bool = True, int8: bool = False,
           generator: Optional[torch.Generator] = None):
    """A model ready for inference on ``device`` (None: CUDA).

    cfg: a config name or a DSL dict. Weights from ``weights`` (a JAX
    checkpoint directory or a ``.pt`` state dict, utils/checkpoint.py), or
    ``state_dict`` (reference layout, unfused), else random from
    ``generator`` (seed 0 when None). BatchNorm is folded unless ``fuse``
    is false; stored parameters are cast to ``dtype``; ``int8`` stores the
    conv weights as int8 (models/quantize.py)."""
    device = select_device(device)
    if isinstance(cfg, str):
        cfg = get_config(cfg, nc=nc)
    model = build_model(cfg, nc=nc, dtype=dtype)
    if weights is not None:
        state_dict = load_inference_params(weights)
    if state_dict is not None:
        load_reference_state_dict(model, state_dict)
    else:
        init_weights(model, generator if generator is not None
                     else torch.Generator().manual_seed(0))
    model.to(device)
    if fuse:
        model.fuse()
    cast_inference_params(model, dtype)
    if int8:
        quantize_int8(model)
    return model.to(memory_format=torch.channels_last)


class DetectionResults:
    """Ragged per-image results (native pixels) with record, pandas, render
    and save views."""

    def __init__(self, boxes: List[np.ndarray], scores: List[np.ndarray],
                 classes: List[np.ndarray], names: Sequence[str],
                 images: Optional[List[np.ndarray]] = None):
        self.boxes = boxes
        self.scores = scores
        self.classes = classes
        self.names = list(names)
        self.images = images
        self.n = len(boxes)

    def __len__(self):
        return self.n

    def _name(self, c) -> str:
        return self.names[int(c)] if int(c) < len(self.names) else str(int(c))

    def records(self) -> List[List[dict]]:
        """Per image, one dict per detection with the columns of
        ``pandas()``: xmin, ymin, xmax, ymax, confidence (floats), class
        (int) and name; no pandas needed."""
        return [[{"xmin": float(bb[0]), "ymin": float(bb[1]),
                  "xmax": float(bb[2]), "ymax": float(bb[3]),
                  "confidence": float(sc), "class": int(c),
                  "name": self._name(c)} for bb, sc, c in zip(b, s, cl)]
                for b, s, cl in zip(self.boxes, self.scores, self.classes)]

    def pandas(self):
        """One DataFrame per image: xmin, ymin, xmax, ymax, confidence,
        class, name."""
        import pandas as pd

        return [pd.DataFrame({
            "xmin": b[:, 0], "ymin": b[:, 1], "xmax": b[:, 2],
            "ymax": b[:, 3], "confidence": s, "class": c.astype(int),
            "name": [self._name(i) for i in c]})
            for b, s, c in zip(self.boxes, self.scores, self.classes)]

    def render(self) -> List[np.ndarray]:
        """The images with their boxes drawn (labels need cv2;
        utils/general.draw_box)."""
        out = []
        for i in range(self.n):
            img = self.images[i].copy()
            for b, s, c in zip(self.boxes[i], self.scores[i], self.classes[i]):
                draw_box(img, b, (255, 56, 56), 2, f"{self._name(c)} {s:.2f}")
            out.append(img)
        return out

    def save(self, save_dir: str = "runs/hub") -> Path:
        """Write the rendered images (JPEG with cv2, else PNG)."""
        d = Path(save_dir)
        for i, img in enumerate(self.render()):
            write_image(d / f"image{i}.jpg", img)
        return d


class Ensemble:
    """Several checkpoints of named configs; ``decode_all`` runs each and
    combines their decoded outputs before NMS by ``mode``: "cat" (the
    default), "mean", "max", or Dempster-Shafer fusion "ds", "ds-li",
    "ds-sun" (the aligned modes need members of one config)."""

    def __init__(self, name_weight_pairs, nc: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, mode: str = "cat",
                 device=None):
        if mode not in ENSEMBLE_MODES:
            raise ValueError(f"unknown ensemble mode {mode!r}")
        self.members = [create(name, nc, weights=w, dtype=dtype,
                               device=device)
                        for name, w in name_weight_pairs]
        self.two_stream = self.members[0].spec.two_stream
        self.nc = self.members[0].spec.nc
        self.mode = mode

    @torch.inference_mode()
    def decode_all(self, rgb, ir=None) -> torch.Tensor:
        """Float (B, H, W, 3) images in [0, 1] (RGB, and IR for
        two-stream members) -> combined (B, N, 5+nc) detections."""
        dev = next(self.members[0].buffers()).device

        def nchw(a):
            return torch.as_tensor(np.asarray(a) if not isinstance(
                a, torch.Tensor) else a).to(dev).permute(0, 3, 1, 2).float()

        ins = (nchw(rgb),) if not self.two_stream else (nchw(rgb), nchw(ir))
        return combine_members([m.decode(m(*ins)) for m in self.members],
                               self.mode)


class Detector:
    """Builds, fuses, casts and places the model once; ``__call__`` serves
    images of any size, ``infer`` canvas-sized uint8 batches.

    cfg: a config name or a DSL dict; ``nc`` None keeps the config's.
    ``weights`` is a checkpoint (a JAX checkpoint directory or a ``.pt``
    state dict) and ``state_dict`` holds reference-layout weights (unfused,
    with BatchNorm); without either the weights are random, drawn from
    ``generator`` (seed 0 when None). ``names`` label the classes (default
    their indices); ``int8`` stores the conv weights as int8
    (models/quantize.py). ``device=None`` means CUDA.
    """

    def __init__(self, cfg: Union[str, dict] = "yolov5l_fusion_transformerx3",
                 nc: Optional[int] = None, state_dict=None,
                 img_size: int = 640, conf: float = 0.25, iou: float = 0.45,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: Optional[torch.Generator] = None, weights=None,
                 names: Optional[Sequence[str]] = None, int8: bool = False):
        self.device = select_device(device)
        self.model = create(cfg, nc, weights=weights, state_dict=state_dict,
                            dtype=dtype, device=self.device,
                            generator=generator, int8=int8)
        self.img_size = img_size
        self.conf = conf
        self.iou = iou
        self.two_stream = self.model.spec.two_stream
        self.names = list(names) if names else [
            str(i) for i in range(self.model.spec.nc)]

    def _to_nchw(self, im) -> torch.Tensor:
        """uint8 (B, S, S, 3) -> float (B, 3, S, S) in [0, 1], channels_last."""
        t = torch.as_tensor(np.asarray(im) if not isinstance(im, torch.Tensor)
                            else im)
        if t.dtype != torch.uint8 or t.dim() != 4 or t.shape[-1] != 3 or \
                t.shape[1:3] != (self.img_size, self.img_size):
            raise ValueError(f"expected uint8 (B, {self.img_size}, "
                             f"{self.img_size}, 3), got {t.dtype} "
                             f"{tuple(t.shape)}")
        t = t.to(self.device, non_blocking=True)
        return t.permute(0, 3, 1, 2).float() / 255.0

    @torch.inference_mode()
    def raw(self, rgb_u8, ir_u8):
        """Raw per-scale Detect outputs (B, ny, nx, na, 5+nc) for a batch."""
        return self.model(self._to_nchw(rgb_u8), self._to_nchw(ir_u8))

    @torch.inference_mode()
    def infer(self, rgb_u8, ir_u8) -> Detections:
        """uint8 RGB and IR batches (B, S, S, 3) -> fixed-size Detections
        (B, 300, ...) in canvas pixels."""
        dets = self.model.decode(self.raw(rgb_u8, ir_u8))
        return batched_nms(dets, conf_thres=self.conf, iou_thres=self.iou,
                           multi_label=False, max_det=300, top_k=1024)

    @staticmethod
    def _to_img(x) -> np.ndarray:
        if isinstance(x, (str, Path)):
            return imread(x)
        return np.asarray(x)

    def prepare(self, imgs, ir_imgs=None):
        """Paths or HWC uint8 RGB arrays (one or a list; and the IR frames
        of a two-stream model) -> (RGB batch, IR batch, per-image letterbox
        metadata, the RGB images). Each frame is letterboxed to the canvas
        with its own ratio (``auto=False``); the boxes are rescaled with
        the RGB frame's metadata, as in the JAX package."""
        if not isinstance(imgs, (list, tuple)):
            imgs = [imgs]
        if ir_imgs is not None and not isinstance(ir_imgs, (list, tuple)):
            ir_imgs = [ir_imgs]
        if self.two_stream and ir_imgs is None:
            raise ValueError("a two-stream model needs IR inputs")
        if ir_imgs is not None and len(ir_imgs) != len(imgs):
            raise ValueError(f"{len(imgs)} RGB and {len(ir_imgs)} IR inputs")
        raw = [self._to_img(x) for x in imgs]
        raw_ir = [self._to_img(x) for x in ir_imgs] if ir_imgs else raw
        s = self.img_size
        rgb, ir, meta = [], [], []
        for r, i2 in zip(raw, raw_ir):
            lb, ratio, pad = letterbox(r, (s, s))
            rgb.append(lb)
            ir.append(letterbox(i2, (s, s))[0] if i2 is not r else lb)
            meta.append((r.shape[:2], ratio, pad))
        return np.stack(rgb), np.stack(ir), meta, raw

    def results(self, det: Detections, meta, raw=None) -> DetectionResults:
        """Detections on the canvas -> native pixels, clipped to each
        image."""
        boxes, scores, classes, valid = (t.cpu().numpy() for t in det)
        boxes_l, scores_l, classes_l = [], [], []
        for i, (hw0, ratio, pad) in enumerate(meta):
            v = valid[i]
            b = boxes[i][v]
            b[:, [0, 2]] = ((b[:, [0, 2]] - pad[0]) / ratio[0]).clip(0, hw0[1])
            b[:, [1, 3]] = ((b[:, [1, 3]] - pad[1]) / ratio[1]).clip(0, hw0[0])
            boxes_l.append(b)
            scores_l.append(scores[i][v])
            classes_l.append(classes[i][v])
        return DetectionResults(boxes_l, scores_l, classes_l, self.names, raw)

    def __call__(self, imgs, ir_imgs=None) -> DetectionResults:
        """Paths or HWC uint8 RGB arrays of any size (and the IR frames of
        a two-stream model) -> ragged detections in native pixels."""
        rgb, ir, meta, raw = self.prepare(imgs, ir_imgs)
        return self.results(self.infer(rgb, ir), meta, raw)
