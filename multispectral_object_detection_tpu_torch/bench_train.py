"""Training-step benchmark of the port: the whole train step on a GPU.

Counterpart of the repository's ``tools/bench_train.py`` (the JAX package's
training bench). The two-stream YOLOv5 with three CFT stages (default
``yolov5l_fusion_transformerx3``, nc=3, random weights from a seeded
``torch.Generator``) takes train steps in bf16 on one repeated batch of
synthetic pairs (``data/synthetic.synthetic_batch``):
forward in training mode, the fp32 loss, gradients, one SGD micro-batch of
the recipe (scratch hyps, 100 steps per epoch, 300 epochs, accumulation to
64), the EMA on emitted steps.

    python -m multispectral_object_detection_tpu_torch.bench_train
        [--cfg yolov5l_fusion_transformerx3] [--img 640] [--batch 8]
        [--steps 20] [--warmup 3] [--remat none|blocks|full|dots]
        [--device cuda]

On a GPU the timed window is ``--steps`` steps between two CUDA events,
after ``--warmup`` steps, synchronised; ``peak_gb`` is
``torch.cuda.max_memory_allocated`` over the steps less what the process
held before ``prepare`` (so, within a larger program, the training's own
peak), and ``state_gb`` the part of it held between steps (model, EMA,
optimizer state, batch). ``--device cpu`` runs on the CPU (a host clock
then times it, and no memory is read). Prints one JSON line: ms per step,
steps/s, images/s, peak and state GB, the host's ms per step to enqueue
the window's work (near ms per step when the host limits the step), the
loss of every step (fetched once, after the run) and the card's name and
power limit.
Without a GPU and without ``--device cpu`` it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .bench import card, log
from .data.synthetic import synthetic_batch
from .models.configs import get_config
from .models.detect import anchor_arrays
from .models.model import build_model, init_weights
from .train.loss import DetectionLoss, LossHyp
from .train.optim import OptHyp, build_optimizer
from .train.trainer import REMAT, TrainState, make_train_step
from .utils.general import select_device

MAX_LABELS = 64  # padded target rows per image, as the JAX training bench


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m multispectral_object_detection_tpu_torch.bench_train")
    ap.add_argument("--cfg", default="yolov5l_fusion_transformerx3")
    ap.add_argument("--img", type=int, default=640)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--remat", default="none", choices=REMAT)
    ap.add_argument("--device", type=str, default="cuda")
    return ap.parse_args(argv)


def prepare(args: argparse.Namespace):
    """(state, step, batch on the device) as the bench runs them."""
    device = select_device(args.device)
    nc = 3
    model = build_model(get_config(args.cfg, nc=nc), dtype=torch.bfloat16)
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(device).to(memory_format=torch.channels_last)
    spec = model.spec
    loss_fn = DetectionLoss(nc, anchor_arrays(spec.anchors), spec.strides,
                            LossHyp())
    accumulate = max(round(64 / args.batch), 1)
    opt = build_optimizer(model, OptHyp(), 100, 300, accumulate, args.batch)
    state = TrainState(model, opt)
    step = make_train_step(state, loss_fn, remat=args.remat)
    batch = tuple(torch.from_numpy(a).to(device) for a in synthetic_batch(
        args.batch, args.img, nc, MAX_LABELS, seed=0))
    return state, step, batch


def allocated(device) -> int:
    """Bytes of device memory held by tensors now (0 off the GPU)."""
    device = torch.device(device)
    return torch.cuda.memory_allocated(device) if device.type == "cuda" \
        else 0


def measure(args: argparse.Namespace, state, step, batch,
            base_bytes: int = 0) -> dict:
    """Time the steps; ``base_bytes`` is ``allocated`` before ``prepare``
    (memory that is not the bench's)."""
    device = batch[0].device
    on_gpu = device.type == "cuda"
    if on_gpu:
        torch.cuda.reset_peak_memory_stats(device)
    resident = allocated(device)
    losses = []
    t0 = time.perf_counter()
    for i in range(max(args.warmup, 1)):
        losses.append(step(*batch, seed=i)["total"])
    if on_gpu:
        torch.cuda.synchronize(device)
    log(f"first step + warm-up: {time.perf_counter() - t0:.1f} s")
    first = len(losses)
    if on_gpu:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for i in range(args.steps):
        losses.append(step(*batch, seed=first + i)["total"])
    host_ms = (time.perf_counter() - t0) * 1e3
    if on_gpu:
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
    else:
        ms = host_ms
    per = ms / args.steps
    out = {"metric": f"train_step_{args.cfg}_{args.img}_bs{args.batch}"
                     f"_remat_{args.remat}",
           "ms_per_step": per, "steps_per_s": 1e3 / per,
           "images_per_s": args.batch * 1e3 / per,
           "host_ms_per_step": host_ms / args.steps,
           "peak_gb": ((torch.cuda.max_memory_allocated(device)
                        - base_bytes) / 1e9 if on_gpu else None),
           "state_gb": (resident - base_bytes) / 1e9 if on_gpu else None,
           "losses": torch.stack(losses).tolist(),
           "device": str(device), "card": card(device)}
    log(f"{args.steps} steps x bs{args.batch} @{args.img} remat={args.remat}:"
        f" {per:.3f} ms/step, {out['images_per_s']:.1f} images/s")
    return out


def run(argv=None) -> dict:
    """Parse ``argv``, build, time; the result line as a dict."""
    args = parse_args(argv)
    base = allocated(select_device(args.device))
    return measure(args, *prepare(args), base_bytes=base)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        base = allocated(select_device(args.device))
    except RuntimeError as e:
        log(f"bench_train: {e}")
        return 1
    print(json.dumps(measure(args, *prepare(args), base_bytes=base)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
