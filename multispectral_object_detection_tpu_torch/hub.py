"""Serving entry point: a detector over batches of uint8 RGB+IR images.

Counterpart of the inference core of multispectral_object_detection_tpu/
hub.py (``Detector._compile``'s ``infer``) and of the pipeline that
bench.py times: pixels / 255 -> BN-folded forward in the compute dtype
(the CFT stacks through the CUDA kernels) -> decode -> batched NMS.
Letterboxing of arbitrary images and ragged per-image results wait for the
serving slice.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from .models.configs import get_config
from .models.model import (build_model, cast_inference_params, init_weights,
                           load_reference_state_dict)
from .ops.nms import Detections, batched_nms
from .utils.general import select_device


class Detector:
    """Builds, fuses, casts and places the model once; ``infer`` serves.

    cfg: a config name or a DSL dict. ``state_dict`` holds reference-layout
    weights (unfused, with BatchNorm); without it the weights are random,
    drawn from ``generator`` (seed 0 when None). ``device=None`` means CUDA.
    """

    def __init__(self, cfg: Union[str, dict] = "yolov5l_fusion_transformerx3",
                 nc: int = 1, state_dict=None, img_size: int = 640,
                 conf: float = 0.25, iou: float = 0.45,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: Optional[torch.Generator] = None):
        self.device = select_device(device)
        if isinstance(cfg, str):
            cfg = get_config(cfg, nc=nc)
        model = build_model(cfg, nc=nc, dtype=dtype)
        if state_dict is not None:
            load_reference_state_dict(model, state_dict)
        else:
            init_weights(model, generator if generator is not None
                         else torch.Generator().manual_seed(0))
        model.to(self.device)
        self.model = cast_inference_params(model.fuse(), dtype).to(
            memory_format=torch.channels_last)
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
