"""Grad-CAM and activation-CAM heatmaps over any graph node.

Counterpart of multispectral_object_detection_tpu/utils/gradcam.py. The
JAX model's ``tap_index``/``tap`` (its models/model.py) becomes ``tap``, a
forward hook on node ``layer`` that adds a zero tensor with
``requires_grad`` to its output and keeps the result: the forward is
unchanged and the gradient of the score with respect to that zero is the
gradient with respect to the node's activation.

- ``mode="grad"``: channel weights are the spatial mean of d(score)/dA,
  CAM = ReLU(sum_c w_c A_c). The CUDA kernels have no backward, so the
  forward runs differentiable twins (models/model.py ``plain_kernels``):
  the CFT stages ``cft_stack_train`` without dropout (the JAX package's
  scan stack, as its Grad-CAM builds the model without Pallas) and the
  C3 bottlenecks their plain version.
- ``mode="sum"``: ReLU of the channel sum, under no_grad, through the
  kernels (K1 on the card).

Score: the sum of objectness over all anchors, or with ``class_id`` of
objectness times that class's probability (decoded detections).

CLI, on the card unless ``--device cpu``:

    python -m multispectral_object_detection_tpu_torch.utils.gradcam \\
        --cfg ... --weights ... --source1 rgb [--source2 ir] --layers 4 17

writes ``cam_<stem>_l<layer>.jpg`` overlays (PNG where cv2 is absent).
The overlay resizes the CAM with the port's C++ runtime (cv2's
INTER_LINEAR on floats) and colours it with cv2's JET table, made here.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def tap(model, layer: int, add: Optional[torch.Tensor] = None,
        grad: bool = False):
    """Within: node ``layer``'s output gets ``add`` added (or, with
    ``grad``, a zero tensor that requires a gradient), and the dict yielded
    receives ``"act"``, the node's output after the addition, and ``"tap"``,
    the tensor added (at the node's last call)."""
    n = len(model.model)
    if not 0 <= layer < n:
        raise ValueError(f"tap_index {layer} is not a node of this graph "
                         f"(0..{n - 1})")
    box: dict = {}

    def hook(module, inputs, out):
        if not isinstance(out, torch.Tensor):
            raise ValueError(f"node {layer} outputs a {type(out).__name__} "
                             f"(a CFT stage's pair): tap one of the nodes "
                             f"that add it to a stream")
        t = add
        if grad:
            t = torch.zeros_like(out, requires_grad=True)
        if t is not None:
            out = out + t.to(out.dtype)
        box["act"], box["tap"] = out, t
        return out

    handle = model.model[layer].register_forward_hook(hook)
    try:
        yield box
    finally:
        handle.remove()


def _score(model, feats, class_id: Optional[int]) -> torch.Tensor:
    dets = model.decode(feats)  # (B, N, 5+nc), sigmoided
    obj = dets[..., 4]
    if class_id is None:
        return obj.sum()
    return (obj * dets[..., 5 + class_id]).sum()


def compute_cam(model, rgb: torch.Tensor, ir: Optional[torch.Tensor] = None,
                *, layer: int, mode: str = "grad",
                class_id: Optional[int] = None) -> torch.Tensor:
    """CAM for graph node ``layer`` of an eval-mode model. Inputs are float
    images in [0, 1], NCHW, on the model's device. Returns (B, ny, nx)
    float32 in [0, 1], ny/nx the node's spatial size."""
    if mode not in ("grad", "sum"):
        raise ValueError(f"mode must be 'grad' or 'sum', got {mode!r}")
    inputs = (rgb,) if ir is None else (rgb, ir)
    if mode == "sum":
        with torch.no_grad(), tap(model, layer) as box:
            model(*inputs)
        cam = box["act"].float().sum(1).clamp(min=0.0)
    else:
        from ..models.model import plain_kernels
        from ..ops.cft_stack import cft_stack_train

        with torch.enable_grad(), \
                plain_kernels(model, stack_fn=cft_stack_train), \
                tap(model, layer, grad=True) as box:
            score = _score(model, model(*inputs), class_id)
            (g,) = torch.autograd.grad(score, box["tap"])
        w = g.float().mean((2, 3), keepdim=True)
        cam = (box["act"].detach().float() * w).sum(1).clamp(min=0.0)
    lo = cam.amin((1, 2), keepdim=True)
    rng = cam.amax((1, 2), keepdim=True) - lo
    return (cam - lo) / rng.clamp(min=1e-12)


def jet_lut() -> np.ndarray:
    """cv2's COLORMAP_JET as a (256, 3) uint8 RGB table, built as cv2's
    colormap.cpp builds it: GNU Octave's jet at x = i/255 (evaluated in
    double, stored as float32), resampled by ``linear_colormap`` at its own
    breakpoints in float32 (which moves some entries by an ulp), times 255
    rounded half to even."""
    f = np.float32
    x = np.arange(256) / 255.0

    def band(lo, hi):
        return (x >= lo) & (x < hi)

    y = np.stack([
        band(3 / 8, 5 / 8) * (4 * x - 1.5) + band(5 / 8, 7 / 8)
        + (x >= 7 / 8) * (-4 * x + 4.5),
        band(1 / 8, 3 / 8) * (4 * x - 0.5) + band(3 / 8, 5 / 8)
        + band(5 / 8, 7 / 8) * (-4 * x + 3.5),
        (x < 1 / 8) * (4 * x + 0.5) + band(1 / 8, 3 / 8)
        + band(3 / 8, 5 / 8) * (-4 * x + 2.5)], 1).astype(f)
    bp = np.arange(256, dtype=f) * (f(1) / f(255))  # cv2's linspace
    dx = (bp[1:] - bp[:-1])[:, None]
    out = y.copy()
    out[1:] = y[:-1] + (dx * (y[1:] - y[:-1])) / dx
    return np.rint(out * f(255)).clip(0, 255).astype(np.uint8)


def overlay_cam(img_u8: np.ndarray, cam: np.ndarray) -> np.ndarray:
    """JET overlay: ``img_u8`` (H, W, 3) RGB uint8, ``cam`` (ny, nx) in
    [0, 1] -> (H, W, 3) RGB uint8, heatmap + img/255 renormalised by the
    max (the reference's show_cam_on_image)."""
    from ..data.native import resize_f32

    h, w = img_u8.shape[:2]
    cam_hw = resize_f32(np.asarray(cam, np.float32), h, w)
    heat = jet_lut()[np.uint8(255 * cam_hw)].astype(np.float32) / 255.0
    out = heat + np.float32(img_u8) / 255.0
    return np.uint8(255 * out / out.max())


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        "python -m multispectral_object_detection_tpu_torch.utils.gradcam",
        description="Grad-CAM heatmaps for any graph node")
    p.add_argument("--cfg", required=True)
    p.add_argument("--weights", required=True,
                   help="checkpoint dir (the port's or the JAX package's) "
                        "or a .pt state dict")
    p.add_argument("--source1", required=True, help="RGB image or directory")
    p.add_argument("--source2", default=None, help="IR image or directory")
    p.add_argument("--layers", type=int, nargs="+", required=True,
                   help="graph node indices to visualize")
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--nc", type=int, default=80)
    p.add_argument("--mode", choices=["grad", "sum"], default="grad")
    p.add_argument("--class-id", type=int, default=None,
                   help="score = obj * P(class); default sums objectness")
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--project", default="runs/gradcam")
    p.add_argument("--name", default="exp")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--device", type=str, default="",
                   help="'' = cuda (fails without a GPU), 'cpu', 'cuda:N' "
                        "or a CUDA index N")
    return p.parse_args(argv)


def run(args) -> list:
    """Write one overlay per image pair and layer; returns their paths."""
    from ..data.augment import letterbox
    from ..data.datasets import list_images
    from ..data.imageio import imread
    from ..hub import create
    from ..models.configs import get_config
    from .general import (check_img_size, device_from_arg, increment_path,
                          write_image)

    device = device_from_arg(args.device)
    s = check_img_size(args.img_size, 32)
    save_dir = increment_path(Path(args.project) / args.name,
                              exist_ok=args.exist_ok)
    save_dir.mkdir(parents=True, exist_ok=True)
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    cfg = args.cfg if args.cfg.endswith((".yaml", ".yml")) else \
        get_config(args.cfg, nc=args.nc)
    model = create(cfg, args.nc, weights=args.weights, dtype=dtype,
                   device=device)
    two_stream = model.spec.two_stream
    if two_stream and not args.source2:
        raise SystemExit("two-stream model needs --source2")

    def load(path):
        im = imread(str(path))
        lb = letterbox(im, (s, s))[0]
        x = torch.from_numpy(np.ascontiguousarray(lb)).to(device)
        return im, x.permute(2, 0, 1)[None].float() / 255.0

    rgbs = list_images(args.source1)
    irs = list_images(args.source2) if two_stream else [None] * len(rgbs)
    written = []
    for p1, p2 in zip(rgbs, irs):
        im0, x1 = load(p1)
        x2 = load(p2)[1] if two_stream else None
        for layer in args.layers:
            cam = compute_cam(model, x1, x2, layer=layer, mode=args.mode,
                              class_id=args.class_id)
            out = overlay_cam(im0, cam[0].cpu().numpy())
            f = write_image(save_dir / f"cam_{Path(p1).stem}_l{layer}.jpg",
                            out)
            written.append(f)
            logger.info("%s: layer %d -> %s", Path(p1).name, layer, f)
    logger.info("%d heatmaps -> %s", len(written), save_dir)
    return written


def main(argv=None) -> int:
    from .general import device_from_arg

    logging.basicConfig(format="%(message)s", level=logging.INFO)
    args = parse_args(argv)
    try:
        device_from_arg(args.device)
    except RuntimeError as e:
        print(f"gradcam: {e}", file=sys.stderr)
        return 1
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
