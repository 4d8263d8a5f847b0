"""Export CLI of the port, the counterpart of ``export.py``
(multispectral_object_detection_tpu/cli/export_cli.py): a ``torch.export``
program (``model.pt2``) of uint8 NHWC batches -> decoded detections (and,
with ``--with-nms``, the fixed-size NMS output), plus ``manifest.json`` with
the JAX manifest's keys.

    python -m multispectral_object_detection_tpu_torch.cli.export_cli \\
        --weights <checkpoint dir or .pt> [--cfg ...] [--with-nms] [...]

``torch.export`` cannot trace the ctypes-bound CUDA kernels, so the
exported program carries the plain PyTorch CFT stack and C3 bottleneck
(models/model.py ``plain_kernels``), chosen here explicitly, as the JAX
export carries no Pallas kernel; the manifest's ``cft_stack`` says so.
``--with-nms`` traces ``ops/nms.batched_nms`` in its fixed-trip form (all
``max_det`` iterations, no host read). Load with ``torch.export.load(path)
.module()(rgb, ir)`` on the device it was exported on. ``--saved-model``
and ``--tflite`` are the JAX package's (jax2tf) and exit here.
``--device`` defaults to CUDA and fails without a GPU.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path

import torch

logger = logging.getLogger(__name__)

# --with-nms settings of the exported graph, as in the JAX export
NMS_KW = dict(conf_thres=0.25, iou_thres=0.45, multi_label=False,
              max_det=300, top_k=1024)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        "python -m multispectral_object_detection_tpu_torch.cli.export_cli")
    ap.add_argument("--cfg", type=str, default="yolov5l_fusion_transformerx3")
    ap.add_argument("--weights", type=str, required=True)
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--nc", type=int, default=1)
    ap.add_argument("--out", type=str, default="",
                    help="output directory (default <weights>/export)")
    ap.add_argument("--with-nms", action="store_true",
                    help="bake the fixed-trip NMS into the program")
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--saved-model", action="store_true",
                    help="JAX only (jax2tf): use the JAX package's export")
    ap.add_argument("--tflite", action="store_true",
                    help="JAX only (jax2tf): use the JAX package's export")
    ap.add_argument("--grid", action="store_true",
                    help="accepted: the program always runs Detect's grid "
                         "decode; add --with-nms for NMS")
    ap.add_argument("--device", type=str, default="",
                    help="'' = cuda (fails without a GPU), 'cpu', 'cuda:N' "
                         "or a CUDA index N; the program runs there")
    ap.add_argument("--dynamic", action="store_true",
                    help="accepted: exports the requested fixed shape (one "
                         "program per deployment shape), as the JAX export")
    ap.add_argument("--simplify", action="store_true",
                    help="accepted: no-op (torch.export's graph is already "
                         "functional and decomposed)")
    return ap.parse_args(argv)


class ExportForward(torch.nn.Module):
    """uint8 (B, S, S, 3) RGB (and IR) -> decoded (B, N, 5+nc) detections,
    or with ``with_nms`` (boxes, scores, classes, valid)."""

    def __init__(self, model, with_nms: bool):
        super().__init__()
        self.model = model
        self.with_nms = with_nms

    def forward(self, rgb, ir):
        from ..ops.nms import batched_nms
        from ..train.eval_forward import model_inputs

        dets = self.model.decode(self.model(*model_inputs(self.model, rgb,
                                                          ir)))
        if not self.with_nms:
            return dets
        d = batched_nms(dets, fixed_trip=True, **NMS_KW)
        return d.boxes, d.scores, d.classes, d.valid


def export(model, batch: int, img_size: int, with_nms: bool, device):
    """The ExportedProgram of ``ExportForward`` at a fixed input shape,
    traced through the kernels' plain twins."""
    from ..models.model import plain_kernels

    # two tensors: one passed twice would make the inputs one placeholder
    rgb, ir = (torch.zeros((batch, img_size, img_size, 3), dtype=torch.uint8,
                           device=device) for _ in range(2))
    with torch.no_grad(), plain_kernels(model):
        return torch.export.export(ExportForward(model, with_nms).eval(),
                                   (rgb, ir))


def run(args) -> str:
    from ..hub import create
    from ..models.configs import get_config
    from ..utils.general import device_from_arg

    for flag, on in (("--saved-model", args.saved_model),
                     ("--tflite", args.tflite)):
        if on:
            raise SystemExit(f"export_cli: {flag} is a jax2tf format of the "
                             f"JAX package (export.py); the port exports "
                             f"torch.export programs")
    device = device_from_arg(args.device)
    if args.dynamic:
        logger.info("--dynamic: exporting the requested fixed shape, as the "
                    "JAX export does (one program per deployment shape)")
    if args.simplify:
        logger.info("--simplify: no-op")
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    cfg = args.cfg if args.cfg.endswith((".yaml", ".yml")) else \
        get_config(args.cfg, nc=args.nc)
    model = create(cfg, args.nc, weights=args.weights, dtype=dtype,
                   device=device)
    b, s = args.batch_size, args.img_size
    program = export(model, b, s, args.with_nms, device)

    out = Path(args.out or (Path(args.weights) / "export"))
    out.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, str(out / "model.pt2"))
    two = model.spec.two_stream
    manifest = {
        "cfg": args.cfg, "nc": args.nc, "two_stream": two,
        "input": {"shape": [b, s, s, 3], "dtype": "uint8",
                  "order": ["rgb", "ir"] if two else ["rgb"]},
        "strides": list(model.spec.strides),
        "anchors": [list(a) for a in model.spec.anchors],
        "with_nms": args.with_nms,
        "platforms": [device.type],
        "cft_stack": "plain PyTorch (torch.export cannot trace the CUDA "
                     "kernels; the JAX export carries no Pallas kernel)",
    }
    (out / "manifest.json").write_text(json.dumps(manifest, indent=1))
    logger.info(f"exported torch.export program -> {out}")
    return str(out)


def main(argv=None) -> int:
    from ..utils.general import device_from_arg

    logging.basicConfig(format="%(message)s", level=logging.INFO)
    args = parse_args(argv)
    try:
        device_from_arg(args.device)
    except RuntimeError as e:
        print(f"export_cli: {e}", file=sys.stderr)
        return 1
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
