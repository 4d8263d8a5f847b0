"""Throughput benchmark of the port: dual-stream inference pairs/s on a GPU.

Counterpart of the repository's root ``bench.py`` (the JAX package's
benchmark), with the same pipeline and legs. uint8 RGB and IR batches
(numpy seeds 0 and 1) on the device -> / 255 -> the BN-folded two-stream
YOLOv5 with three CFT stages in bf16 (random weights from a seeded
``torch.Generator``; stored params cast to bf16 unless ``--fp32-params``;
optionally weights-only int8) -> forward, or three-scale TTA -> decode ->
batched NMS (conf 0.25, IoU 0.45, max_det 300, top_k 1024) unless
``--no-nms``. ``--c3-kernel`` routes the C3 bottlenecks that fit it through
the fused C3 kernel (the JAX bench's ``--pallas-c3``).

    python -m multispectral_object_detection_tpu_torch.bench [--batch 16]
        [--iters 32] [--warmup 3] [--img 640] [--scale l] [--no-nms]
        [--fp32-params] [--int8] [--tta] [--c3-kernel] [--device cuda]

On a GPU the timed window is ``--iters`` batches between two CUDA events,
after ``--warmup`` batches, synchronised. ``--device cpu`` runs the plain
PyTorch versions on the CPU (a host clock then times it). Prints one JSON
line to stdout: ``metric``, ``value`` (pairs/s), ``unit``, the card's name
and power limit, and the number of model forwards run; diagnostics go to
stderr. Without a GPU and without ``--device cpu`` it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from .models.configs import yolov5_two_stream
from .models.model import build_model, cast_inference_params, init_weights
from .models.quantize import quantize_int8, quantized_bytes
from .ops.nms import batched_nms
from .train.tta import SCALES, tta_forward
from .utils.general import select_device


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m multispectral_object_detection_tpu_torch.bench")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--img", type=int, default=640)
    ap.add_argument("--scale", type=str, default="l")
    ap.add_argument("--no-nms", action="store_true")
    ap.add_argument("--fp32-params", action="store_true",
                    help="keep stored params fp32 (compute stays bf16)")
    ap.add_argument("--int8", action="store_true",
                    help="weights-only int8: conv weights stored int8 with a "
                         "per-channel scale, dequantized to bf16 at use")
    ap.add_argument("--tta", action="store_true",
                    help="test-time augmentation: 3 scales + flip")
    ap.add_argument("--c3-kernel", action="store_true",
                    help="route the fitting C3 bottlenecks through the "
                         "fused C3 kernel (ops/c3_bottleneck.py)")
    ap.add_argument("--device", type=str, default="cuda")
    return ap.parse_args(argv)


def metric_name(args: argparse.Namespace) -> str:
    return (f"cft_{args.scale}_{args.img}_dual_stream_inference"
            f"{'_tta' if args.tta else ''}_pairs_per_sec_per_chip")


def card(device: torch.device) -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        out = f"{torch.cuda.get_device_name(device)}, power limit not read"
    return out


def prepare(args: argparse.Namespace):
    """The model as the bench runs it, the ``infer`` function of one batch,
    and the two uint8 input batches on the device."""
    device = select_device(args.device)
    dt = torch.bfloat16
    model = build_model(yolov5_two_stream(args.scale, nc=1,
                                          fusion="transformerx3"),
                        dtype=dt, use_c3_kernel=args.c3_kernel)
    init_weights(model, torch.Generator().manual_seed(0))
    log(f"params = {sum(p.numel() for p in model.parameters()):,}")
    model = model.to(device).fuse()
    if not args.fp32_params:
        cast_inference_params(model, dt)
    if args.int8:
        quantize_int8(model)
        log(f"int8 params: {quantized_bytes(model) / 1e6:.0f} MB")
    model = model.to(memory_format=torch.channels_last)
    b, s = args.batch, args.img
    rgb, ir = (torch.from_numpy(np.random.default_rng(seed).integers(
        0, 255, size=(b, s, s, 3), dtype=np.uint8)).to(device)
        for seed in (0, 1))

    @torch.inference_mode()
    def infer(rgb_u8, ir_u8):
        # NHWC uint8 -> NCHW float in channels_last memory (a free permute)
        x, x2 = (t.permute(0, 3, 1, 2).float() / 255.0 for t in (rgb_u8, ir_u8))
        if args.tta:
            dets = tta_forward(model, x, x2)
        else:
            dets = model.decode(model(x, x2))
        if args.no_nms:
            return dets
        return batched_nms(dets, conf_thres=0.25, iou_thres=0.45,
                           multi_label=False, max_det=300, top_k=1024)

    return model, infer, rgb, ir


def measure(args: argparse.Namespace, infer, rgb, ir) -> dict:
    """Times ``args.iters`` batches after ``args.warmup`` (at least one)."""
    device = rgb.device
    on_gpu = device.type == "cuda"
    t0 = time.perf_counter()
    warm = max(args.warmup, 1)
    for _ in range(warm):
        infer(rgb, ir)
    if on_gpu:
        torch.cuda.synchronize(device)
    log(f"first run + warm-up: {time.perf_counter() - t0:.1f} s")
    if on_gpu:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            infer(rgb, ir)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
    else:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            infer(rgb, ir)
        ms = (time.perf_counter() - t0) * 1e3
    pairs_per_sec = args.batch * args.iters * 1e3 / ms
    log(f"{args.iters} iters x bs{args.batch} in {ms:.3f} ms -> "
        f"{pairs_per_sec:.1f} pairs/s ({ms / args.iters:.3f} ms per batch)")
    return {"metric": metric_name(args), "value": pairs_per_sec,
            "unit": "image-pairs/s", "card": card(device),
            "forwards": (warm + args.iters) * (len(SCALES) if args.tta else 1)}


def run(argv=None) -> dict:
    """Parse ``argv``, build, time; the result line as a dict."""
    args = parse_args(argv)
    return measure(args, *prepare(args)[1:])


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        select_device(args.device)
    except RuntimeError as e:
        log(f"bench: {e}")
        return 1
    print(json.dumps(measure(args, *prepare(args)[1:])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
