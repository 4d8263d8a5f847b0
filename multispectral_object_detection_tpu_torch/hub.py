"""Model factory, ensembles and the detector over batches of uint8 images.

Counterparts of multispectral_object_detection_tpu/hub.py: ``create``
builds a named config with random weights or a checkpoint's, in its
inference form; ``DetectionResults`` holds ragged per-image results;
``Ensemble`` combines several checkpoints' decoded outputs; ``Detector``
is the serving core (``Detector._compile``'s ``infer``), the pipeline that
bench.py times: pixels / 255 -> BN-folded forward in the compute dtype (the
CFT stacks through the CUDA kernels) -> decode -> batched NMS.
Letterboxing of arbitrary images waits for the serving slice.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .models.configs import get_config
from .models.model import (build_model, cast_inference_params, init_weights,
                           load_reference_state_dict)
from .models.quantize import quantize_int8
from .ops.nms import Detections, batched_nms
from .train.eval_forward import ENSEMBLE_MODES, combine_members
from .utils.checkpoint import load_inference_params
from .utils.general import select_device


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
    """Ragged per-image results (native pixels) with a pandas view."""

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
        """The images with their boxes drawn (needs cv2)."""
        import cv2

        out = []
        for i in range(self.n):
            img = self.images[i].copy()
            for b, s, c in zip(self.boxes[i], self.scores[i], self.classes[i]):
                cv2.rectangle(img, (int(b[0]), int(b[1])),
                              (int(b[2]), int(b[3])), (255, 56, 56), 2)
                cv2.putText(img, f"{self._name(c)} {s:.2f}",
                            (int(b[0]), int(b[1]) - 4),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.6, (255, 56, 56), 2)
            out.append(img)
        return out

    def save(self, save_dir: str = "runs/hub") -> Path:
        """Write the rendered images as JPEG (needs cv2)."""
        import cv2

        d = Path(save_dir)
        d.mkdir(parents=True, exist_ok=True)
        for i, img in enumerate(self.render()):
            cv2.imwrite(str(d / f"image{i}.jpg"), img[:, :, ::-1])
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
    """Builds, fuses, casts and places the model once; ``infer`` serves.

    cfg: a config name or a DSL dict. ``weights`` is a checkpoint (a JAX
    checkpoint directory or a ``.pt`` state dict) and ``state_dict`` holds
    reference-layout weights (unfused, with BatchNorm); without either the
    weights are random, drawn from ``generator`` (seed 0 when None).
    ``device=None`` means CUDA.
    """

    def __init__(self, cfg: Union[str, dict] = "yolov5l_fusion_transformerx3",
                 nc: int = 1, state_dict=None, img_size: int = 640,
                 conf: float = 0.25, iou: float = 0.45,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: Optional[torch.Generator] = None, weights=None):
        self.device = select_device(device)
        self.model = create(cfg, nc, weights=weights, state_dict=state_dict,
                            dtype=dtype, device=self.device,
                            generator=generator)
        self.img_size = img_size
        self.conf = conf
        self.iou = iou

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
