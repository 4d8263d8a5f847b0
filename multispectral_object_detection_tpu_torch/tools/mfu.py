"""Model FLOPs utilisation: FLOPs per pair (or per train step) times a
measured rate over the card's peak. The port's counterpart of
``tools/mfu.py``, with its flags and JSON keys:

    MFU = FLOPs per pair * pairs per second / peak FLOP/s

    python -m multispectral_object_detection_tpu_torch.tools.mfu \\
        [--cfg yolov5l_fusion_transformerx3] [--img 640] [--tta] \\
        [--pairs-per-s 540]                  # from the port's bench
    python -m ... --train --batch 8 --remat blocks --ms-per-step 650
                                             # from the port's bench_train

The count runs on the card by default (``--device cpu`` on the CPU) under
``torch.utils.flop_counter.FlopCounterMode``, which counts matrix products
and convolutions at 2 FLOPs per multiply-add (not elementwise work,
normalisation or softmax). The inference forward is
``utils/profiling.estimate_flops`` (nc=3, one pair at ``--img``), with
the kernels' plain twins swapped in, since the counter does not see the
ctypes-bound kernels; ``--tta`` counts ``train/tta.py``'s three-pass
forward the same way. ``--train`` counts one train step of
``bench_train.prepare`` (forward in training mode, whose CFT stages run
``cft_stack_train``, loss and backward; with ``--remat blocks`` the
recomputed forward too, since it runs), not the optimizer's or the EMA's
elementwise work.

The peak is the card's dense bf16 rate, looked up by
``torch.cuda.get_device_name``: the H100 SXM (``NVIDIA H100 80GB HBM3``)
989.4 TFLOP/s, the H100 PCIe 756.5 (NVIDIA's data sheets). On another card
it exits and asks for ``--peak``. The card's name and power limit are
printed with it (a card held below its maximum power runs below the
peak). With ``--device cpu`` it prints the FLOPs alone unless ``--peak``
is given.
"""

from __future__ import annotations

import argparse
import json
import sys

# dense bf16 FLOP/s by torch.cuda.get_device_name (NVIDIA data sheets)
PEAK_BF16 = {"NVIDIA H100 80GB HBM3": 989.4e12, "NVIDIA H100 PCIe": 756.5e12}
COUNTED = "matrix products and convolutions, 2 FLOPs per multiply-add"


def card_peak(name: str, peak: float = 0.0) -> float:
    """``peak`` if given, else the dense bf16 peak of the card ``name``;
    exits asking for ``--peak`` on a card not in ``PEAK_BF16``."""
    if peak:
        return peak
    if name not in PEAK_BF16:
        raise SystemExit(f"mfu: no bf16 peak known for {name!r}; pass "
                         f"--peak FLOP/s (known: {sorted(PEAK_BF16)})")
    return PEAK_BF16[name]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        "python -m multispectral_object_detection_tpu_torch.tools.mfu")
    ap.add_argument("--cfg", default="yolov5l_fusion_transformerx3")
    ap.add_argument("--img", type=int, default=640)
    ap.add_argument("--pairs-per-s", type=float, default=0.0,
                    help="measured throughput from the port's bench; 0 = "
                         "only print FLOPs/pair")
    ap.add_argument("--peak", type=float, default=0.0,
                    help="peak FLOP/s; default: the card's dense bf16 peak")
    ap.add_argument("--tta", action="store_true",
                    help="count the 3-scale+flip TTA forward (train/tta.py) "
                         "instead of the plain forward")
    ap.add_argument("--train", action="store_true",
                    help="count one train step instead of the inference "
                         "forward")
    ap.add_argument("--batch", type=int, default=8,
                    help="train-step batch size (--train only)")
    ap.add_argument("--remat", default="none",
                    choices=["none", "dots", "full", "blocks"])
    ap.add_argument("--ms-per-step", type=float, default=0.0,
                    help="measured train-step latency from the port's "
                         "bench_train (--train only)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="where the count runs: 'cuda' (fails without a "
                         "GPU), 'cuda:N' or 'cpu'")
    return ap.parse_args(argv)


def forward_flops(args, device) -> float:
    """FLOPs of one pair's inference forward (``--tta``: its three
    passes)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..models.configs import get_config
    from ..models.model import build_model, plain_kernels
    from ..utils.profiling import estimate_flops

    model = build_model(get_config(args.cfg, nc=3), dtype=torch.bfloat16,
                        device=device)
    if not args.tta:
        flops = estimate_flops(model, args.img)
        if flops is None:
            raise RuntimeError("the FLOP count failed")
        return flops
    from ..train.tta import tta_forward

    x = torch.zeros((1, 3, args.img, args.img), device=device)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), plain_kernels(model), counter:
        tta_forward(model, x, x if model.spec.two_stream else None)
    return float(counter.get_total_flops())


def train_step_flops(args, device) -> float:
    """FLOPs of one train step of ``args.batch`` pairs, as ``bench_train``
    builds it (so the counted step is the timed one)."""
    from torch.utils.flop_counter import FlopCounterMode

    from .. import bench_train

    bargs = bench_train.parse_args(["--cfg", args.cfg, "--img",
                                    str(args.img), "--batch",
                                    str(args.batch), "--remat", args.remat,
                                    "--device", str(device)])
    state, step, batch = bench_train.prepare(bargs)
    counter = FlopCounterMode(display=False)
    with counter:
        step(*batch, seed=0)
    return float(counter.get_total_flops())


def result(args: argparse.Namespace, flops: float, peak: float,
           card_line: str) -> dict:
    """The JSON line of ``flops`` counted for ``args``: FLOPs, and where a
    rate and a peak are known the achieved TFLOP/s and the MFU."""
    out = {"cfg": args.cfg, "img": args.img, "counted": COUNTED}
    if args.train:
        out.update(batch=args.batch, remat=args.remat,
                   gflops_per_step=flops / 1e9,
                   gflops_per_pair=flops / args.batch / 1e9)
    else:
        out.update(tta=bool(args.tta), gflops_per_pair=flops / 1e9)
    rate = args.ms_per_step if args.train else args.pairs_per_s
    if rate and not peak:
        print("mfu: no peak on the CPU; pass --peak for the MFU",
              file=sys.stderr)
    if rate and peak:
        if args.train:
            achieved = flops / (args.ms_per_step / 1e3)
            out["ms_per_step"] = args.ms_per_step
        else:
            achieved = flops * args.pairs_per_s
            out["pairs_per_s"] = args.pairs_per_s
        out.update(achieved_tflops=achieved / 1e12,
                   mfu_pct=100 * achieved / peak)
    if peak:
        out.update(peak_tflops=peak / 1e12, card=card_line)
    return out


def run(args: argparse.Namespace) -> dict:
    """Count on ``--device`` and return the tool's JSON line as a dict."""
    import torch

    from ..bench import card
    from ..utils.general import select_device

    device = select_device(args.device)
    peak = args.peak
    if device.type == "cuda":
        peak = card_peak(torch.cuda.get_device_name(device), args.peak)
    flops = train_step_flops(args, device) if args.train else \
        forward_flops(args, device)
    return result(args, flops, peak, card(device))


def main(argv=None) -> int:
    from ..utils.general import select_device

    args = parse_args(argv)
    try:
        select_device(args.device)
    except RuntimeError as e:
        print(f"mfu: {e}", file=sys.stderr)
        return 1
    print(json.dumps(run(args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
