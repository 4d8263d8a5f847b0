"""Evaluation forwards: uint8 batches on the device -> decoded detections.

Counterpart of ``make_eval_forward``, ``make_eval_forward_ensemble`` and
``make_eval_forward_tta`` of multispectral_object_detection_tpu/train/
trainer.py. Each returns a function of (rgb, ir), uint8 (B, H, W, 3)
tensors on the model's device, that divides by 255 and returns (decoded
(B, N, 5+nc) fp32 detections, the raw head outputs or None). The models
are built, fused and cast by the caller; the CFT stages run through
``ops/cft_stack.fused_cft_stack`` (the CUDA kernels on the card).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..ops.ds_fusion import fuse_detections
from .tta import tta_forward

ENSEMBLE_MODES = ("cat", "mean", "max", "ds", "ds-li", "ds-sun")
_DS_METHOD = {"ds": "plain", "ds-li": "li", "ds-sun": "sun"}


def model_inputs(model, rgb: torch.Tensor, ir: torch.Tensor):
    """uint8 NHWC -> float NCHW in [0, 1] (channels_last memory, a free
    permute); the IR input only for two-stream models."""
    x = rgb.permute(0, 3, 1, 2).float() / 255.0
    if not model.spec.two_stream:
        return (x,)
    return x, ir.permute(0, 3, 1, 2).float() / 255.0


def make_eval_forward(model) -> Callable:
    """Forward + decode; returns (detections, raw head outputs)."""

    @torch.inference_mode()
    def fwd(rgb, ir):
        feats = model(*model_inputs(model, rgb, ir))
        return model.decode(feats), feats

    return fwd


def combine_members(dets: Sequence[torch.Tensor], mode: str) -> torch.Tensor:
    """Decoded outputs of same-config members -> one (B, N', 5+nc):
    "cat" concatenates the candidates (member-major), "mean"/"max" reduce
    per anchor, "ds"/"ds-li"/"ds-sun" fuse per anchor by Dempster-Shafer
    evidence combination (ops/ds_fusion.py)."""
    if mode == "cat":
        return torch.cat(list(dets), dim=1)
    if mode not in ENSEMBLE_MODES:
        raise ValueError(f"unknown ensemble mode {mode!r}")
    if len({tuple(d.shape) for d in dets}) != 1:
        raise ValueError("aligned ensemble modes need same-config members")
    stacked = torch.stack(list(dets))
    if mode == "mean":
        return stacked.mean(dim=0)
    if mode == "max":
        return stacked.amax(dim=0)
    return fuse_detections(stacked, method=_DS_METHOD[mode])


def make_eval_forward_ensemble(models: Sequence, mode: str = "cat") -> Callable:
    """Multi-checkpoint ensemble: the members (separate models of one
    config) run one after another, then combine by ``mode``
    (``combine_members``). Returns (detections, None): no raw outputs, as
    the JAX ensemble forward."""
    if mode not in ENSEMBLE_MODES:
        raise ValueError(f"unknown ensemble mode {mode!r}")

    @torch.inference_mode()
    def fwd(rgb, ir):
        return combine_members([m.decode(m(*model_inputs(m, rgb, ir)))
                                for m in models], mode), None

    return fwd


def make_eval_forward_tta(model) -> Callable:
    """Test-time augmentation (3 scales, a left-right flip; train/tta.py)
    + decode. Returns (detections, None): the scales' raw outputs differ
    in shape."""

    @torch.inference_mode()
    def fwd(rgb, ir):
        return tta_forward(model, *model_inputs(model, rgb, ir)), None

    return fwd
