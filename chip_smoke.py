#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It imports nothing of JAX and nothing of the JAX package. Phases; any
failure raises and the script exits non-zero:

1. the card's name and power limit; build the CUDA kernels from
   ``multispectral_object_detection_tpu_torch/kernels/csrc`` (one nvcc per
   source, all at once).
2. every kernel against its plain PyTorch version on the card, in bf16 and
   fp32, TF32 off: LayerNorm at M=2048, the four GEMMs of a layer at the CFT
   stages' widths of the l and x scales (C up to 1280) at M=2048 and at
   M=1024 with C=320 (N=960, not a multiple of 128) and C=192 (the m
   scale), the attention at head widths 8 to 160 (24 and 40 included) with
   128 tokens and with 100 (the masked edge), the whole 8-layer stack, and
   the fused C3 bottleneck (K2) at the shapes of the l@640 and x@1024 bench
   legs, at an odd shape and at the edges of its TMA boxes (an image
   smaller than one box, ragged boxes, C = 192 and 320), in bf16 with bf16
   and fp32 biases and in fp32; greedy NMS's suppression (K3) against the
   plain loop, bit for bit, at the eval protocol's shapes (32 images of
   20,160 and of 30,000 candidates, max_det 300, 1 and 0; one image of one
   candidate); deformable attention's sampling (K4) against its plain
   ``grid_sample`` twin in bf16 and fp32 at the DETR cell's encoder (8
   images of 21,760 tokens) and decoder shapes (300 queries, reference of
   batch 8 and 1), one launch a call.
3. the main path: ``Detector`` on the l-scale two-stream transformerx3
   config (nc=1, random weights from a seed, BN folded, bf16) serves three
   requests of 16 uint8 640x640 RGB+IR pairs. Checks the output shapes and
   values, that the kernel launch counters rose by exactly the launches of
   three forwards (K2 none: it is off by default), and that the raw head
   outputs agree with a run through the plain stack. Then the DETR cell's
   path: a Deformable DETR R50 (bf16, seeded official init with a non-zero
   box head) serves ``Detector.infer`` on 8 uint8 frames at 1024 px; the
   K4 launches of one call (12) and its logits and boxes against the same
   call on the plain path.
4. the port's bench (``multispectral_object_detection_tpu_torch.bench``) at
   full width, a few batches per leg: default, ``--c3-kernel``, ``--int8``,
   ``--tta --c3-kernel``, ``--fp32-params``, ``--no-nms`` at l@640 bs16, and
   ``--c3-kernel`` at x@1024 bs8. Checks each leg's launch counts (K2 at
   exactly 42 blocks of two launches per l forward, 24 per x forward) and
   that the ``--c3-kernel`` forward agrees with one through K2's plain
   version; that forward's device time by kind of operation; the device
   time of the three forwards of a ``--tta`` batch, with K2 and without.
5. the eval path: the port's test CLI (``cli.test_cli.run``, data as a
   dict) on a synthetic set of 64 seeded PNG pairs at 640x512 (LLVIP's
   aspect, nc=1) with random-weight reference-layout ``.pt`` checkpoints
   of the l-scale model (seeds 0 and 1), at the CLI defaults (batch 32,
   640 px, rect batches, conf 0.001, IoU 0.6, bf16): ``val``,
   ``--save-hybrid``, ``--augment``, two checkpoints with
   ``--ensemble-mode cat`` and ``ds``, ``--int8`` and ``--task speed``.
   Checks finite metrics over all 64 images, hybrid mAP50 and mAP >= 0.95,
   the K1 launches of every run's forwards, one K3 launch per batch, and
   one eval batch's decoded
   outputs through the kernels against the plain stack; one evaluate pass
   of two batches under the profiler gives the device's idle ms by program
   span (``tools/profile_model.idle_by_span``). Then a JPEG leg
   with PIL and cv2 unimportable: ``val`` over 16 LLVIP-sized JPEG pairs
   made of the committed fixtures (tests/data/jpeg, with the labels of the
   generator and seed that made them): the scan's counters (0 corrupt),
   finite metrics, K1's launches and one batch against the plain stack.
   Prints an ``{"eval": {...}}`` line (s per image, forward / NMS /
   matching ms per image, NMS candidates per image and iterations per
   batch, mAP50, mAP; the JPEG leg under ``jpeg``).
6. the serving path: a ``Detector`` built from a seeded random-weight
   ``.pt`` of the l-scale model (BN folded, bf16, conf 0.01) serves
   ``Detector.__call__`` on 16 PNG pairs at FLIR's 640x512 (letterbox pad
   only) and at LLVIP's 1280x1024 (a resize), with K1's 168 launches per
   forward counted and the boxes checked against ``Detector.infer`` on the
   same letterboxed batch, rescaled; ms per call split into host decode +
   letterbox, forward + NMS and rescale; the device letterbox
   (``ops/preprocess.letterbox_batch``) against the host one on the
   1280x1024 batch, timed; the native JPEG decode (libjpeg where the
   machine has ``jpeglib.h``, else nvJPEG where it has CUDA's
   ``nvjpeg.h``) of the committed fixtures (tests/data/jpeg) against
   cv2's stored decode, and the variant fixtures (tests/data/jpeg/variants:
   EXIF orientations 1-8, progressive, gray, CMYK) through ``imread``
   against cv2.imread's stored decodes; an orientation-6 pair through
   ``Detector.__call__`` against the same pixels served pre-rotated as PNG;
   ``apply_classifier`` on one served image with a seeded stand-in
   classifier; the detect CLI headless (``--nosave --save-txt``)
   and saving on 16 LLVIP-sized PNG pairs and 16 JPEG pairs
   (``--batch-size 16``), its label files against ``Detector.__call__``'s,
   fps and fps_steady; the REST service on a loopback port, one PNG pair
   and one JPEG pair, its JSON against ``Detector.__call__``'s records; a
   ``{"serving": {...}}`` line.
7. timing with CUDA events: each kernel over one forward's launches at the
   main path's shapes (K2 at the ``--c3-kernel`` leg's), beside its bound,
   its achieved TFLOP/s and share of the bound, its plain version and one
   PyTorch library call for the same function; LayerNorm and attention at
   the x scale's P5 stage, K2 over one x@1024 bs8 forward's 24 blocks, and
   K2's two launches apart; K3 at an eval batch's shapes (device ms, ms a
   pick, its byte bound, the plain loop's ms); K4 at the DETR cell's
   shapes (``k4_timing``: device ms of an encoder and a decoder call at 8
   images and of a forward's 12 calls, beside K4's own bound from the
   bytes its inputs make it gather and its fp32 FLOPs, and beside
   ``work_detr``'s bound; the plain twin's ms as the yardstick); the main
   path's ms per batch and its
   profile.
8. training (about two minutes): one fp32 train step of the n-scale
   two-stream CFT (nc=2, 128 px, batch 2, dropout off, TF32 off) on the
   card against the CPU (loss and every gradient); one bf16 step of the
   l model at 640, batch 8, with remat none and blocks (equal loss and
   BatchNorm statistics, a nonzero gradient on every CFT weight); the
   port's training bench (``bench_train``) for both, 20 steps on one
   repeated batch of synthetic pairs (ms per step, images/s, peak GB, a
   falling loss); the train CLI for 2 epochs of the l model at 640, batch 8,
   on 16 synthetic PNG pairs (K1's 168 launches per eval forward of the EMA
   model, and K1 against its plain twin on the trained EMA weights), the
   stripped checkpoint through the test CLI with ``--compute-loss``, and
   the detect CLI's ``--update`` (the run's resume at epoch 2 is phase
   11c's); a ``{"train": {...}}`` line.
9. device augmentation and the parallel path: (a) the device mosaic
   (``ops/augment_device.py``) at l@640 bs8 on tiles of the synthetic
   pairs, the card against the CPU on the same draws, ms per batch by CUDA
   events beside the host's ``collate_tiles`` and host-augmented
   ``collate_batch`` (median of 5 batches after one, decodes cached); (b) the train CLI with ``--device-aug`` (2 epochs of
   the l model at 640, batch 8, 2 steps each) and ``--quad`` (1 epoch),
   K1's 168 launches per EMA eval forward, and ``--evolve 2`` on the n
   model; (c) the data-parallel step and eval at world 1 over NCCL against
   one process, bit-equal under deterministic algorithms (losses, BatchNorm
   statistics, gradients and updated weights; the eval metrics equal);
   (d) two gloo ranks sharing
   the card, an fp32 l@640 step of 4 images per rank against one
   process's step on all 8 (loss, statistics, gradients); a
   ``{"parallel_aug": {...}}`` line.
10. the long tail: (a) the 13 hub configs of tests/test_model.py at full
   width with their parameter pins, one fused bf16 forward of each (batch
   2 at 640 px, 1280 for the P6 family) against the unfused fp32 model,
   ms per batch; ``hubconf.yolov5l6`` through ``Detector.__call__``;
   yolov5l6 with ``--c3-kernel`` at 1280 px, K2 at each of its shapes
   (C = 384 new) against the plain twin, its launches and ms, and one
   forward's 48 launches by graph replay beside the plain twin, the cuDNN
   route and the bound (PERF's kernel-table row); (b)
   Grad-CAM on l@640 transformerx3 at three nodes, ``sum`` mode through
   K1 against the plain stack, ``grad`` mode in fp32 card vs CPU on one
   pair at 320 px, the CLI's overlays; (c) the export CLI at l@640 batch
   1 with and without ``--with-nms``, ``torch.export.load`` on the card
   against ``Detector.infer``, export and run times; (d) ``model_info``
   of l@640 with the CFT layers' FLOPs against K1's analytic count; (e)
   ``test_cli --plots`` (without matplotlib: its exit message) and the
   train CLI for one epoch with ``--wandb`` and no wandb; a
   ``{"long_tail": {...}}`` line.
11. the port's tools (``multispectral_object_detection_tpu_torch.tools``):
   (a) ``profile_model`` at l@640 bs16, default and ``--c3-kernel``
   (K1's 168 launches per forward, K2's 84 with the flag, the kinds summing
   to the device time; phases 4, 7 and 8 print their breakdowns through
   the same module); (b) ``mfu`` at l@640: the forward's GFLOPs per pair
   against ``model_info``'s count (within 0.1 %), the MFU of phase 4's
   default leg and of phase 8's train steps (remat none and blocks)
   against the card's named peak; (c) ``resume_runs`` continuing phase
   8's 2-epoch train CLI run, raised to 3 epochs in its ``opt.yaml``, at
   epoch 2 (K1's 168 launches per eval forward); (d) ``dataset_tools`` (autosplit,
   extract-boxes, flatten) on phase 5's 64 synthetic PNG pairs (one PNG
   crop per label row, equal to its source region); (e)
   ``export_torch_ckpt`` on a pickled reference-style checkpoint of the l
   model (its class in a ``--repo`` directory) to a ``.pt``, bit-equal to
   the source and serving the same boxes through ``Detector``; (f) the
   train CLI with ``--cfg`` the reference-grammar YAML of the l model
   (tests/data/yolov5l_fusion_transformerx3.yaml) and PyYAML unimportable,
   one step and its eval (K1's 168 launches per eval forward); a
   ``{"tools": {...}}`` line.
12. a ``{"kernels": [...]}`` line, the script's seconds in all, the card
   line, and the final ``{"ok": true, "device": {...}}`` line.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}

B, N_TOK, L, HEADS = 16, 128, 8, 8      # CFT stage on the main path
M = B * N_TOK
STAGE_WIDTHS = (256, 512, 1024)           # P3, P4, P5
X_P5 = 1280                               # the x scale's P5 stage
# GEMM checks at M = 1024 (x@1024 bs8): C = 320 (QKV N = 960, not a multiple
# of 128) and C = 192 (the m scale's P3 stage)
GEMM_M1024_WIDTHS = (320, 192)
ATTN_WIDTHS = (8, 24, 32, 40, 64, 128, 136, X_P5 // 8)  # head widths checked
ATTN_N_EDGE = 100                          # tokens per image, masked edge
IMG, BATCH, REQUESTS = 640, 16, 3
# eval phase: LLVIP-shaped synthetic pairs (h, w), at the test CLI's defaults
EVAL_IMAGES, EVAL_HW, EVAL_BATCH = 64, (512, 640), 32
EVAL_MIN_HYBRID_MAP = 0.95
EVAL_JPEG_PAIRS = 16  # phase 5's JPEG leg, from the committed fixtures
JPEG_DIR = Path(__file__).resolve().parent / "tests" / "data" / "jpeg"
# serving phase: FLIR's and LLVIP's frames (h, w), 16 pairs per call; random
# weights score about 0.02 (the Detect head's objectness prior), so a
# threshold of 0.01 leaves detections to compare
SERVE_SIZES = {"flir": (512, 640), "llvip": (1024, 1280)}
SERVE_BATCH, SERVE_CONF, SERVE_REPEATS = 16, 0.01, 3
# mean |decode - cv2's| on 0-255: IDCT rounding and chroma upsampling of
# another decoder (the JAX copy's bound)
JPEG_MEAN_TOL = 2.0
# K2 blocks of one l@640 bs16 forward with --c3-kernel: (B, H, W, C), count
K2_BLOCKS = (((16, 160, 160, 64), 6), ((16, 80, 80, 128), 18),
             ((16, 40, 40, 256), 18))
K2_X_SHAPE, K2_X_BLOCKS = (8, 64, 64, 320), 24  # x@1024 bs8
K2_ODD_SHAPE = (2, 17, 23, 64)
# shapes at the edges of K2's TMA boxes (8 x 8 pixels x 64 channels): an
# image smaller than one box, ragged boxes in H and W at C = 128, three
# and five 64-channel slabs
K2_EDGE_SHAPES = ((1, 3, 5, 64), (2, 13, 19, 128), (2, 24, 40, 192),
                  (2, 24, 40, 320))
# K3 (greedy NMS) at the eval protocol's shapes: (images, candidates an
# image, max_det, clusters, conf); 20,160 is one 640x512 canvas's anchors at
# nc 1, 30,000 the top_k cut of nc 3 with multi-label candidates; boxes
# spread over the canvas (clusters 0) or packed into clusters, where most
# candidates die and the picks reach K3's last tiles. The last row is the
# serve cells' call (16 images, top_k 1024, max_det 300) with no candidate
# past the gate, as a random-weight head gives none at conf 0.25.
K3_SHAPES = ((32, 20160, 300, 0, 0.001), (32, 30000, 300, 0, 0.001),
             (32, 20160, 1, 0, 0.001), (32, 20160, 0, 0, 0.001),
             (1, 1, 300, 0, 0.001), (32, 20160, 300, 24, 0.001),
             (8, 20160, 2000, 24, 0.001), (16, 1024, 300, 0, 1.0))
K3_IOU = 0.6
# K4 (deformable attention's sampling) at the DETR cell's shapes: 8 heads of
# 32 channels, 4 levels of a 1024 px canvas (21,760 tokens), 4 points, 300
# decoder queries, 6 encoder and 6 decoder calls a forward
K4_LEVELS = ((128, 128), (64, 64), (32, 32), (16, 16))
K4_HEADS, K4_POINTS, K4_QUERIES, K4_CALLS = 8, 4, 300, 6
K4_BATCH, K4_IMG = 8, 1024  # the cell's batch and canvas
# max |K4 - plain| / max |plain|: in bf16 both store the bf16 rounding of
# fp32 sums that agree to about 1e-6 (at most one bf16 ulp apart: 2^-8 of
# the largest output; two allowed); in fp32 the sums' order and the pixel
# coordinate's rounding (loc * W - 0.5 against grid_sample's chain)
K4_TOL = {"bfloat16": 8e-3, "float32": 2e-5}
K4 = {"name": "msda_sample", "route": "cuda", "source": "multispectral_"
      "object_detection_tpu_torch/kernels/csrc/msda.cu", "replaces": "none: "
      "the grid_sample path of ops/msda.ms_deform_attn (the JAX package has "
      "no DETR)"}
K3 = {"name": "nms_suppress", "route": "cuda", "source": "multispectral_"
      "object_detection_tpu_torch/kernels/csrc/nms.cu", "replaces": "none: "
      "the Python loop of ops/nms._suppress (the JAX package's NMS is an "
      "XLA loop)"}
# max |kernel - plain| / max |plain|, with the reason for each bound:
TOL_FP32 = 2e-5        # sum order only (fp32 FMA both sides, no TF32)
TOL_BF16 = 8e-3        # both round the same fp32 value: <= 2 bf16 ulps apart
TOL_BF16_STACK = 1.5e-2  # 8 layers of such rounding points
TOL_BF16_MODEL = 2e-2    # through the rest of the network after 3 stages
CFT_SOURCE = "multispectral_object_detection_tpu/ops/pallas_fusion.py:102"
C3_SOURCE = "multispectral_object_detection_tpu/ops/pallas_c3.py:90"
CSRC = "multispectral_object_detection_tpu_torch/kernels/csrc/"
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "cft_layernorm": (CSRC + "layernorm.cu", CFT_SOURCE),
    "cft_gemm_bias": (CSRC + "gemm.cu", CFT_SOURCE),
    "cft_gemm_gelu": (CSRC + "gemm.cu", CFT_SOURCE),
    "cft_gemm_residual": (CSRC + "gemm.cu", CFT_SOURCE),
    "cft_attention": (CSRC + "attention.cu", CFT_SOURCE),
    "c3_bottleneck": (CSRC + "c3_bottleneck.cu", C3_SOURCE),
    # K2 at the x scale: the 24 blocks of one x@1024 bs8 --c3-kernel forward
    "c3_bottleneck_x": (CSRC + "c3_bottleneck.cu", C3_SOURCE),
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def kernel_launches(since=None) -> dict:
    """K1's launches by kernel (``cft_layernorm``, ...) and K2's
    (``c3_bottleneck``), read from the port's counters (utils/tracing),
    less ``since``, an earlier reading."""
    from multispectral_object_detection_tpu_torch.ops import c3_bottleneck as k2
    from multispectral_object_detection_tpu_torch.ops import cft_stack as cs
    from multispectral_object_detection_tpu_torch.utils import tracing

    now = {n.split(".", 1)[1]: int(tracing.counter(n))
           for n in (*cs.COUNTERS, k2.COUNTER)}
    return now if since is None else {k: v - since[k] for k, v in now.items()}


def k3_launches(since: int = 0) -> int:
    """K3's launches (``k3.nms_suppress``) less ``since``, an earlier
    reading."""
    from multispectral_object_detection_tpu_torch.ops import nms
    from multispectral_object_detection_tpu_torch.utils import tracing

    return int(tracing.counter(nms.COUNTER)) - since


def k1_launches(since) -> int:
    """K1's launches since ``since`` (a ``kernel_launches()`` reading)."""
    return sum(v for k, v in kernel_launches(since).items()
               if k != "c3_bottleneck")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def rel_err(got, ref) -> tuple[float, float]:
    d = (got.float() - ref.float()).abs().max().item()
    return d / max(ref.float().abs().max().item(), 1e-30), d


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, replays: int = 20) -> float:
    """Device time of fn's launches: captured once in a CUDA graph and
    replayed, so the host's cost between launches is left out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture (library handles, workspaces)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters=replays, warmup=2)


def stack_inputs(C: int, dtype, gen, device):
    """x (B, N, C) and the stack's ten weight arguments, random."""
    import torch

    def r(*shape, scale=1.0, dt=dtype):
        return (torch.randn(*shape, generator=gen) * scale).to(device, dt)

    def ln():
        return torch.stack([1 + r(L, C, scale=0.1, dt=torch.float32),
                            r(L, C, scale=0.1, dt=torch.float32)], 1)

    x = r(B, N_TOK, C)
    w = [r(L, C, 3 * C, scale=0.02), r(L, 3 * C, scale=0.02),
         r(L, C, C, scale=0.02), r(L, C, scale=0.02),
         r(L, C, 4 * C, scale=0.02), r(L, 4 * C, scale=0.02),
         r(L, 4 * C, C, scale=0.02), r(L, C, scale=0.02), ln(), ln()]
    return x, w


def k2_inputs(shape, dtype, bias_dtype, gen, device):
    """x (B, H, W, C) and K2's weights w1 (C, C), b1, w2 (9, C, C), b2."""
    import torch

    C = shape[-1]

    def r(*s, scale=1.0, dt=dtype):
        return (torch.randn(*s, generator=gen) * scale).to(device, dt)

    return (r(*shape), r(C, C, scale=C ** -0.5), r(C, scale=0.1, dt=bias_dtype),
            r(9, C, C, scale=(9 * C) ** -0.5), r(C, scale=0.1, dt=bias_dtype))


def phase_checks(torch, cs, k2, device):
    """Phase 2: each kernel and the whole stack against the plain twins.
    Returns the bf16 max abs error per kernel at the main paths' shapes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    worst = {k: 0.0 for k in KERNELS}

    def report(name, dtype, shape, got, ref, tol, counter=None):
        torch.cuda.synchronize()
        rel, abs_err = rel_err(got, ref)
        print(f"check {name:<18} {str(dtype)[6:]:<8} {shape!s:<22} "
              f"rel={rel:.3e} tol={tol:.1e}")
        check(rel <= tol, f"{name} {dtype} {shape}: {rel:.3e} > {tol:.1e}")
        if counter and dtype == torch.bfloat16:
            worst[counter] = max(worst[counter], abs_err)

    def rn(*shape, scale=1.0, dt=torch.float32):
        return (torch.randn(*shape, generator=gen) * scale).to(device, dt)

    for dt in (torch.bfloat16, torch.float32):
        tol = TOL_BF16 if dt == torch.bfloat16 else TOL_FP32
        for C in STAGE_WIDTHS + (X_P5,):
            x = rn(M, C)
            w, b = 1 + rn(C, scale=0.1), rn(C, scale=0.1)
            report("layernorm", dt, (M, C), cs.layer_norm(x, w, b, dt),
                   cs.layer_norm_plain(x, w, b, dt), tol, "cft_layernorm")
        gemm_shapes = [(M, C) for C in STAGE_WIDTHS + (X_P5,)] + [
            (1024, C) for C in GEMM_M1024_WIDTHS]
        for Mg, C in gemm_shapes:
            for K, Nout, epi in ((C, 3 * C, "bias"), (C, C, "residual"),
                                 (C, 4 * C, "gelu"), (4 * C, C, "residual")):
                a = rn(Mg, K, dt=dt)
                ww = rn(K, Nout, scale=K ** -0.5, dt=dt)
                bb = rn(Nout, scale=0.1, dt=dt)
                if epi == "residual":
                    s0 = rn(Mg, Nout)
                    got = cs.linear(a, ww, bb, epi, out=s0.clone())
                    ref = cs.linear_plain(a, ww, bb, epi, out=s0.clone())
                else:
                    got = cs.linear(a, ww, bb, epi)
                    ref = cs.linear_plain(a, ww, bb, epi)
                report(f"gemm_{epi}", dt, (Mg, K, Nout), got, ref, tol,
                       f"cft_gemm_{epi}" if Mg == M else None)
        for D in ATTN_WIDTHS:
            for n_tok in (N_TOK, ATTN_N_EDGE):
                qkv = rn(B * n_tok, 3 * HEADS * D, dt=dt)
                main = n_tok == N_TOK and D * HEADS in STAGE_WIDTHS + (X_P5,)
                report("attention", dt, (B, n_tok, HEADS, D),
                       cs.attention(qkv, B, HEADS),
                       cs.attention_plain(qkv, B, HEADS), tol,
                       "cft_attention" if main else None)
        for C in (64,) + STAGE_WIDTHS + (X_P5,):
            x, w = stack_inputs(C, dt, gen, device)
            report("fused_cft_stack", dt, (B, N_TOK, C, L),
                   cs.fused_cft_stack(x, *w), cs.fused_cft_stack_plain(x, *w),
                   TOL_BF16_STACK if dt == torch.bfloat16 else TOL_FP32)
        # K2; in bf16 with bf16 biases (the cast model) and fp32 ones
        # (--fp32-params)
        l_shapes = tuple(sh for sh, _ in K2_BLOCKS)
        for shape in (l_shapes + (K2_X_SHAPE, K2_ODD_SHAPE)
                      + K2_EDGE_SHAPES):
            for bdt in ((dt,) if dt == torch.float32
                        else (dt, torch.float32)):
                args = k2_inputs(shape, dt, bdt, gen, device)
                name = "c3_bottleneck" + (" b32" if bdt != dt else "")
                report(name, dt, shape, k2.c3_bottleneck(*args),
                       k2.c3_bottleneck_plain(*args), tol,
                       "c3_bottleneck" if shape in l_shapes else
                       "c3_bottleneck_x" if shape == K2_X_SHAPE else None)
                del args
    return worst


def nms_inputs(torch, B: int, K: int, gen, device, clusters: int = 0,
               conf: float = 0.001):
    """``ops/nms._select``'s outputs at the eval protocol (multi-label, conf
    0.001) for B images of K candidates (K3_SHAPES, top_k K): seeded boxes
    in a 640x512 canvas, or in ``clusters`` clusters an image, scores
    rounded to bf16 as the head rounds them (many ties); at conf 1.0 none
    passes the gate and every score is ``_NEG``."""
    from multispectral_object_detection_tpu_torch.ops import nms

    nc = 3 if K > 20160 else 1
    n = 20160 if K > 1 else 1
    xy = torch.rand(B, n, 2, generator=gen) * torch.tensor([640.0, 512.0])
    wh = 10 + 110 * torch.rand(B, n, 2, generator=gen)
    if clusters:
        centres = 100 + 400 * torch.rand(B, clusters, 2, generator=gen)
        pick = torch.randint(0, clusters, (B, n), generator=gen)
        xy = (torch.gather(centres, 1, pick[..., None].expand(-1, -1, 2))
              + 24 * torch.rand(B, n, 2, generator=gen) - 12)
        wh = 30 + 30 * torch.rand(B, n, 2, generator=gen)
    cls = torch.rand(B, n, nc, generator=gen)
    cls = cls / cls.sum(-1, keepdim=True)
    obj = torch.rand(B, n, 1, generator=gen)
    pred = torch.cat([xy, wh, torch.cat([obj, cls], -1).bfloat16().float()],
                     -1).to(device)
    _, shifted, scores, _ = nms._select(pred, conf, None, True, False,
                                        K, None, None, None)
    check(scores.shape == (B, K), f"K3 inputs {tuple(scores.shape)}")
    return shifted, scores


def phase_k3_checks(torch, device) -> int:
    """Phase 2, K3: the kernel against the plain loop on the card at
    K3_SHAPES, indices, validity and both counters bit for bit, one launch
    each. Returns the most output slots that differed at one shape."""
    from multispectral_object_detection_tpu_torch.ops import nms
    from multispectral_object_detection_tpu_torch.utils import tracing

    gen = torch.Generator().manual_seed(3)
    worst = 0
    for B, K, max_det, clusters, conf in K3_SHAPES:
        shifted, scores = nms_inputs(torch, B, K, gen, device, clusters,
                                     conf)
        want_i, want_v, _, want_c = nms._suppress_plain(
            shifted, scores, K3_IOU, max_det)
        before = tracing.counter(nms.COUNTER)
        idxs, vals, picks, cands = nms._suppress(shifted, scores, K3_IOU,
                                                 max_det)
        torch.cuda.synchronize()
        bad = int((idxs != want_i).sum() + (vals != want_v).sum())
        picks, cands = int(picks), int(cands)
        want_p = int(want_v.sum(1).max()) if B else 0
        last = int(idxs[vals].max()) if picks else -1
        worst = max(worst, bad)
        print(f"check nms_suppress       fp32     {(B, K, max_det)!s:<22} "
              f"clusters {clusters} conf {conf}: slots differing {bad}, picks "
              f"{picks}/{want_p}, candidates {cands}/{want_c}, last kept "
              f"index {last}")
        check(bad == 0 and picks == want_p and cands == want_c,
              f"nms_suppress {(B, K, max_det)}: {bad} slots differ, picks "
              f"{picks} != {want_p} or candidates {cands} != {want_c}")
        check(int(tracing.counter(nms.COUNTER) - before) == 1,
              "nms_suppress: not one launch")
    return worst


def k3_timing(torch, device, card: str) -> dict:
    """Phase 7, K3: device ms of one launch at an eval batch's shapes
    (CUDA events over 20 launches), ms a pick, its byte bound (each input
    byte read once, each output byte written once, at 3.35 TB/s) and the
    plain loop's ms (host wall, synchronised: it waits on the device every
    8 steps)."""
    from multispectral_object_detection_tpu_torch.ops import nms

    gen = torch.Generator().manual_seed(4)
    rows = {}
    for B, K, max_det, clusters, conf in (K3_SHAPES[:2] + K3_SHAPES[5:6]
                                         + K3_SHAPES[-1:]):
        shifted, scores = nms_inputs(torch, B, K, gen, device, clusters,
                                     conf)
        ms = cuda_ms(lambda: nms.nms_suppress(shifted, scores, K3_IOU,
                                              max_det), iters=20)
        picks = int(nms.nms_suppress(shifted, scores, K3_IOU,
                                     max_det)[2][:, 1].max())
        plain = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nms._suppress_plain(shifted, scores, K3_IOU, max_det)
            torch.cuda.synchronize()
            plain.append((time.perf_counter() - t0) * 1e3)
        nbytes = B * K * 20 + B * max_det * 9 + B * 16
        row = (f"B{B}_K{K}" + ("_clusters" if clusters else "")
               + ("_empty" if conf >= 1 else ""))
        rows[row] = {
            "ms": ms, "picks": picks, "us_per_pick": ms * 1e3 / max(picks, 1),
            "bytes_bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "plain_ms": statistics.median(plain)}
        r = rows[row]
        print(f"K3 nms_suppress B={B} K={K} max_det={max_det} clusters "
              f"{clusters} conf {conf} on {card}: "
              f"{ms:.4f} ms, {picks} picks, {r['us_per_pick']:.2f} us a "
              f"pick; byte bound {r['bytes_bound_ms']:.4f} ms; plain loop "
              f"{r['plain_ms']:.1f} ms")
    return rows


def msda_inputs(torch, n: int, q: int, ref_batch: int, dtype, gen, device,
                spread: float = 3.0, far: float = 0.0):
    """``ms_deform_attn``'s arguments at K4_LEVELS: value and logits normal;
    offsets the official grid bias (point p of head h at p + 1 pixels along
    the head's direction) plus normal noise of ``spread`` pixels, a share
    ``far`` of them 100 times that; an encoder's reference (q = the tokens,
    ``ref_batch`` 1) each token's pixel centre, a decoder's uniform."""
    from portbench.reference.deformable_detr_weights import grid_bias

    s = sum(h * w for h, w in K4_LEVELS)
    nl = len(K4_LEVELS)
    value = torch.randn(n, s, K4_HEADS, 32, generator=gen)
    off = grid_bias(K4_HEADS, nl, K4_POINTS) + spread * torch.randn(
        n, q, K4_HEADS * nl * K4_POINTS * 2, generator=gen)
    if far:
        off = torch.where(torch.rand(off.shape, generator=gen) < far,
                          off * 100, off)
    logits = 2 * torch.randn(n, q, K4_HEADS * nl * K4_POINTS, generator=gen)
    if q == s:
        ref = torch.cat([torch.stack(torch.meshgrid(
            (torch.arange(w) + 0.5) / w, (torch.arange(h) + 0.5) / h,
            indexing="xy"), -1).reshape(-1, 2) for h, w in K4_LEVELS])
        ref = ref[None].expand(ref_batch, -1, -1)
    else:
        ref = torch.rand(ref_batch, q, 2, generator=gen)
    return (value.to(device, dtype), list(K4_LEVELS),
            ref.contiguous().to(device), off.to(device, dtype),
            logits.to(device, dtype), K4_POINTS)


def phase_k4_checks(torch, device) -> float:
    """Phase 2, K4: ``ms_deform_attn`` (K4) against ``ms_deform_attn_plain``
    on the card on the same inputs, bf16 and fp32, at the DETR cell's
    encoder and decoder shapes (8 images) with offsets of several pixels
    and 5 % far outside, one launch a call. Returns the worst relative
    error of the calls."""
    from multispectral_object_detection_tpu_torch.ops import msda
    from multispectral_object_detection_tpu_torch.utils import tracing

    gen = torch.Generator().manual_seed(5)
    s = sum(h * w for h, w in K4_LEVELS)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for q, ref_batch in ((s, 1), (K4_QUERIES, K4_BATCH), (K4_QUERIES, 1)):
            args = msda_inputs(torch, K4_BATCH, q, ref_batch, dtype, gen,
                               device, far=0.05)
            want = msda.ms_deform_attn_plain(*args)
            before = tracing.counter(msda.COUNTER)
            got = msda.ms_deform_attn(*args)
            torch.cuda.synchronize()
            err = rel_err(got, want)[0]
            same = float((got == want).float().mean())
            name = str(dtype).split(".")[1]
            worst = max(worst, err)
            print(f"check msda_sample        {name:<8} ({K4_BATCH}, {q}, ref "
                  f"{ref_batch}): rel err {err:.3g}, equal {same:.4f}")
            check(err <= K4_TOL[name], f"msda_sample {name} q={q}: rel err "
                  f"{err:.3g} > {K4_TOL[name]}")
            check(int(tracing.counter(msda.COUNTER) - before) == 1,
                  "msda_sample: not one launch")
            del args, want, got
    return worst


def phase_k4_serving(torch, device) -> dict:
    """Phase 3b, K4 on the DETR cell's path: a Deformable DETR R50 (bf16,
    the seeded official init) serves ``Detector.infer`` on a host uint8
    batch of 8 frames at 1024 px. Counts the K4 launches of one call (12:
    6 encoder, 6 decoder), and checks its raw logits and boxes against the
    same call with every MSDA on the plain path. The official init zeroes
    the box head's last layer, so that boxes would be the reference points
    whatever MSDA gives; it is drawn non-zero here, so both outputs read
    the decoder's state."""
    from multispectral_object_detection_tpu_torch.hub import Detector
    from multispectral_object_detection_tpu_torch.models import \
        deformable_detr
    from multispectral_object_detection_tpu_torch.ops import msda
    from multispectral_object_detection_tpu_torch.utils import tracing

    gen = torch.Generator().manual_seed(7)
    det = Detector("deformable_detr_r50", img_size=K4_IMG,
                   dtype=torch.bfloat16, device=device,
                   generator=torch.Generator().manual_seed(1))
    last = det.model.bbox_embed.layers[-1]
    with torch.no_grad():
        last.weight.copy_(0.1 * torch.randn(last.weight.shape, generator=gen))
    x = torch.randint(0, 256, (K4_BATCH, K4_IMG, K4_IMG, 3),
                      generator=gen, dtype=torch.uint8).numpy()
    raws = []
    hook = det.model.register_forward_hook(
        lambda m, i, o: raws.append([t.float().clone() for t in o]))
    try:
        det.infer(x)  # warm-up: builds, algorithms
        torch.cuda.synchronize()
        before = tracing.counter(msda.COUNTER)
        got = det.infer(x)
        torch.cuda.synchronize()
        launches = int(tracing.counter(msda.COUNTER) - before)
        real = deformable_detr.ms_deform_attn
        deformable_detr.ms_deform_attn = msda.ms_deform_attn_plain
        try:
            det.infer(x)
        finally:
            deformable_detr.ms_deform_attn = real
    finally:
        hook.remove()
    (logits, boxes), (want_logits, want_boxes) = raws[1], raws[2]
    errs = {"logits": rel_err(logits, want_logits)[0],
            "boxes": rel_err(boxes, want_boxes)[0]}
    size_std = float(boxes[..., 2:].std())
    print(f"check msda_sample        bfloat16 DETR R50 Detector.infer "
          f"{K4_BATCH} x {K4_IMG} px: {launches} K4 launches a call; "
          f"against the plain path logits rel err {errs['logits']:.3g}, "
          f"boxes {errs['boxes']:.3g} (box sizes' std {size_std:.3g}); "
          f"{int(got.valid.sum())} detections past conf")
    check(launches == 2 * K4_CALLS, f"DETR infer: {launches} K4 launches")
    check(max(errs.values()) <= TOL_BF16_MODEL, f"DETR infer: rel err {errs}")
    check(size_std > 1e-2, f"DETR infer: box sizes' std {size_std:.3g}: the "
          "boxes do not read the decoder's state")
    del det, raws
    torch.cuda.empty_cache()
    return {"launches": launches, **errs}


def k4_bytes(torch, value, shapes, reference, offsets, logits,
             points) -> int:
    """The bytes one K4 call must move through device memory, counted from
    its inputs: each (image, pixel, head) line of the value that a corner
    inside its level reads, once (at the cell's encoder shapes nearly the
    whole value; a decoder call reads a part); the offsets and logits in
    their dtype; the reference; the output once."""
    n, s, m, d = value.shape
    q, nl = offsets.shape[1], len(shapes)
    dev = value.device
    off = offsets.float().view(n, q, m, nl, points, 2)
    ref = reference.float()[:, :, None, None, :]
    seen = torch.zeros(n * s * m, dtype=torch.bool, device=dev)
    base = (torch.arange(n, device=dev, dtype=torch.float64) * s).view(
        n, 1, 1, 1)
    head = torch.arange(m, device=dev, dtype=torch.float64).view(1, 1, m, 1)
    start = 0
    for lid, (h, w) in enumerate(shapes):
        o = off[:, :, :, lid]
        # the pixel coordinates as K4 rounds them (fp32)
        ix = ((ref[..., 0] + o[..., 0] / w) * w - 0.5).floor().double()
        iy = ((ref[..., 1] + o[..., 1] / h) * h - 0.5).floor().double()
        for dy in (0, 1):
            for dx in (0, 1):
                x, y = ix + dx, iy + dy
                ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
                line = (base + start + y * w + x) * m + head
                seen[line[ok].long()] = True
        start += h * w
    itemsize = value.element_size()
    return (int(seen.sum()) * d * itemsize
            + (offsets.numel() + logits.numel()) * itemsize
            + reference.numel() * reference.element_size()
            + n * q * m * d * itemsize)


def k4_timing(torch, device, card: str) -> dict:
    """Phase 7, K4: device ms of one encoder call (8 images of 21,760
    tokens) and one decoder call (300 queries) at the DETR cell's shapes in
    bf16 (CUDA-graph replay of 20 calls, so the host's cost between
    launches is left out; offsets the official grid bias plus 1.5 px of
    noise, as the benchmark's seeded draw gives them), and a forward's 12
    calls, each beside K4's own bound: the larger of ``k4_bytes`` at the
    memory peak and its 10 fp32 FLOPs a channel-sample (4 corners and the
    weight, as fused multiply-adds on the CUDA cores) at the fp32 peak.
    Beside it ``work_detr``'s bound, the benchmark's yardstick, which
    counts the whole value map for every call and 12 B of fp32 locations
    and weights a sample (K4 reads 6 B of bf16 offsets and logits). Also
    the host's us to enqueue one ``ms_deform_attn`` call, and the plain
    twin's ms on the card (CUDA events; the ``grid_sample`` path, the
    yardstick's ``library_ms``)."""
    from multispectral_object_detection_tpu_torch.ops import msda
    from portbench import work, work_detr

    cfg = json.loads((Path(__file__).resolve().parent / "portbench" /
                      "configs" / "deformable-detr-r50-1024.json").read_text())
    peaks = work.peaks(torch.cuda.get_device_name(0))
    calls = work_detr.msda_calls(cfg, K4_BATCH, (K4_IMG, K4_IMG))
    gen = torch.Generator().manual_seed(6)
    s = sum(h * w for h, w in K4_LEVELS)
    rows = {}
    for name, q, ref_batch, call in (("encoder", s, 1, calls[0]),
                                     ("decoder", K4_QUERIES, K4_BATCH,
                                      calls[-1])):
        args = msda_inputs(torch, K4_BATCH, q, ref_batch, torch.bfloat16, gen,
                           device, spread=1.5)
        ms = graph_ms(lambda: msda.msda_sample(*args), replays=20)
        plain = cuda_ms(lambda: msda.ms_deform_attn_plain(*args), iters=5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            msda.ms_deform_attn(*args)
        host_us = (time.perf_counter() - t0) / 50 * 1e6
        torch.cuda.synchronize()
        nbytes = k4_bytes(torch, *args)
        flops = 10.0 * K4_BATCH * q * K4_HEADS * len(K4_LEVELS) * K4_POINTS \
            * 32
        bound = (work.bound_ms([(nbytes, flops, "fp32")], peaks) if peaks
                 else float("nan"))
        by = ("fp32 FLOPs" if peaks and flops / peaks["fp32_flops_per_s"]
              > nbytes / peaks["hbm_bytes_per_s"] else "bytes")
        bench = work.bound_ms([call], peaks) if peaks else float("nan")
        rows[name] = {"ms": ms, "plain_ms": plain, "bytes": nbytes,
                      "flops": flops, "bound_ms": bound, "bound_by": by,
                      "of_bound": bound / ms, "bench_bound_ms": bench,
                      "host_us": host_us}
        print(f"K4 msda_sample {name} call bs{K4_BATCH} q={q} on {card}: "
              f"{ms:.4f} ms; K4's bound {bound:.4f} ms ({nbytes / 1e6:.1f} "
              f"MB, {flops / 1e9:.2f} GFLOP fp32; by {by}; "
              f"{100 * bound / ms:.1f} %); "
              f"work_detr's bound {bench:.4f} ms; host {host_us:.1f} us to "
              f"enqueue a call; plain grid_sample path {plain:.3f} ms")
        del args
    fwd = {k: K4_CALLS * (rows["encoder"][k] + rows["decoder"][k])
           for k in ("ms", "plain_ms", "bound_ms")}
    fwd["of_bound"] = fwd["bound_ms"] / fwd["ms"]
    fwd["bench_bound_ms"] = (work_detr.msda_bound_ms(
        cfg, K4_BATCH, (K4_IMG, K4_IMG), peaks) if peaks else float("nan"))
    rows["forward"] = fwd
    print(f"K4 msda_sample a forward's {2 * K4_CALLS} calls at "
          f"bs{K4_BATCH}: {fwd['ms']:.4f} ms, K4's bound "
          f"{fwd['bound_ms']:.4f} ms ({100 * fwd['of_bound']:.1f} %), "
          f"work_detr's bound {fwd['bench_bound_ms']:.4f} ms "
          f"({100 * fwd['bench_bound_ms'] / fwd['ms']:.1f} %); plain "
          f"{fwd['plain_ms']:.2f} ms")
    return rows


def phase_main_path(torch, device):
    """Phase 3: the Detector serves REQUESTS batches through the kernels."""
    from multispectral_object_detection_tpu_torch.hub import Detector
    from multispectral_object_detection_tpu_torch.models.fusion import (
        CrossModalFusion)
    from multispectral_object_detection_tpu_torch.ops import cft_stack as cs

    t0 = time.perf_counter()
    det = Detector("yolov5l_fusion_transformerx3", nc=1, img_size=IMG,
                   dtype=torch.bfloat16, device=device,
                   generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    print(f"main path: Detector built (random weights, BN folded, bf16) in "
          f"{time.perf_counter() - t0:.1f} s")
    stages = [m for m in det.model.modules() if isinstance(m, CrossModalFusion)]
    layers = sum(m.wqkv.shape[0] for m in stages)
    per_forward = {"cft_layernorm": 2 * layers, "cft_gemm_bias": layers,
                   "cft_gemm_gelu": layers, "cft_gemm_residual": 2 * layers,
                   "cft_attention": layers}
    check(len(stages) == 3 and layers == 3 * L,
          f"expected 3 CFT stages of {L} layers, got {len(stages)}/{layers}")

    gen = torch.Generator(device=device).manual_seed(1)
    batches = [tuple(torch.randint(0, 256, (BATCH, IMG, IMG, 3),
                                   dtype=torch.uint8, device=device,
                                   generator=gen) for _ in range(2))
               for _ in range(REQUESTS)]
    l0, k3_0 = kernel_launches(), k3_launches()
    outs = [det.infer(rgb, ir) for rgb, ir in batches]
    torch.cuda.synchronize()
    launches = kernel_launches(l0)
    want = {k: REQUESTS * v for k, v in per_forward.items()}
    want["c3_bottleneck"] = 0  # off by default, as in the JAX package
    launches["nms_suppress"] = k3_launches(k3_0)
    want["nms_suppress"] = REQUESTS  # one batched_nms a call
    print(f"main path: kernel launches over {REQUESTS} requests {launches}")
    check(launches == want, f"launch counts {launches} != {want}")
    for o in outs:
        check(tuple(o.boxes.shape) == (BATCH, 300, 4)
              and tuple(o.scores.shape) == (BATCH, 300)
              and tuple(o.classes.shape) == (BATCH, 300)
              and tuple(o.valid.shape) == (BATCH, 300),
              "Detections shapes")
        check(o.valid.dtype == torch.bool and o.classes.dtype == torch.int32,
              "Detections dtypes")
        check(bool(torch.isfinite(o.boxes).all() and
                   torch.isfinite(o.scores).all()), "non-finite detections")
        check(bool(((o.scores >= 0) & (o.scores <= 1)).all()),
              "scores outside [0, 1]")
    n_valid = [int(o.valid.sum()) for o in outs]
    print(f"main path: detections per request {n_valid}")

    rgb, ir = batches[0]
    raw_k = det.raw(rgb, ir)
    dec = det.model.decode(raw_k)
    check(tuple(dec.shape) == (BATCH, 3 * sum((IMG // s) ** 2 for s in
                                              (8, 16, 32)), 6),
          f"decoded shape {tuple(dec.shape)}")
    check(bool(torch.isfinite(dec).all()), "non-finite decoded predictions")
    for m in stages:
        m.stack_fn = cs.fused_cft_stack_plain
    raw_p = det.raw(rgb, ir)
    for m in stages:
        m.stack_fn = cs.fused_cft_stack
    torch.cuda.synchronize()
    worst = max(rel_err(k, p)[0] for k, p in zip(raw_k, raw_p))
    print(f"main path: raw head outputs, kernels vs plain stack: rel={worst:.3e}"
          f" tol={TOL_BF16_MODEL:.1e}")
    check(worst <= TOL_BF16_MODEL, f"raw outputs disagree: {worst:.3e}")
    return det, batches, stages, launches


def phase_bench(torch, device):
    """Phase 4: every leg of the port's bench at full width, a few batches
    each, with the launch counts of each leg's run, the device ms of one
    forward (graph replay) of the default, --c3-kernel and x legs and of a
    --tta batch's three forwards (with K2 and without), and the
    --c3-kernel forward's profile. Returns the legs' result lines and the K2
    launches of the --c3-kernel leg and of the x leg."""
    from multispectral_object_detection_tpu_torch import bench
    from multispectral_object_detection_tpu_torch.models.fusion import (
        CrossModalFusion)
    from multispectral_object_detection_tpu_torch.models.layers import (
        Bottleneck)
    from multispectral_object_detection_tpu_torch.ops import c3_bottleneck as k2
    from multispectral_object_detection_tpu_torch.train.tta import (
        FLIPS, SCALES, _scale_img)

    few = ["--iters", "5", "--warmup", "1"]
    x_leg = ["--scale", "x", "--img", "1024", "--batch", "8", "--c3-kernel"]
    legs = [[], ["--c3-kernel"], ["--int8"], ["--tta", "--c3-kernel"],
            ["--fp32-params"], ["--no-nms"], x_leg]
    results, fwd_ms, k2_launches = {}, {}, {}
    for leg in legs:
        name = " ".join(leg) or "default"
        args = bench.parse_args(leg + few)
        t0 = time.perf_counter()
        model, infer, rgb, ir = bench.prepare(args)
        stages = [m for m in model.modules() if isinstance(m, CrossModalFusion)]
        blocks = [m for m in model.modules()
                  if isinstance(m, Bottleneck) and m.takes_kernel]
        layers = sum(m.wqkv.shape[0] for m in stages)
        print(f"bench leg {name}: built in {time.perf_counter() - t0:.1f} s; "
              f"CFT stages C={[m.d_model for m in stages]}, K2 blocks "
              f"{len(blocks)} at C={sorted({m.cv1.conv.out_channels for m in blocks})}")
        l0 = kernel_launches()
        res = bench.measure(args, infer, rgb, ir)
        torch.cuda.synchronize()
        got = kernel_launches(l0)
        fw = res["forwards"]
        want = {"cft_layernorm": 2 * layers * fw, "cft_gemm_bias": layers * fw,
                "cft_gemm_gelu": layers * fw,
                "cft_gemm_residual": 2 * layers * fw,
                "cft_attention": layers * fw,
                "c3_bottleneck": 2 * len(blocks) * fw}
        print(f"bench leg {name}: {fw} forwards, launches {got}")
        check(got == want, f"leg {name}: launch counts {got} != {want}")
        want_blocks = {"--c3-kernel": 42, "--tta --c3-kernel": 42,
                       " ".join(x_leg): 24}.get(name, 0)
        check(len(blocks) == want_blocks,
              f"leg {name}: {len(blocks)} K2 blocks, expected {want_blocks}")
        if leg is x_leg:
            check([m.d_model for m in stages] == [320, 640, X_P5] and
                  {m.cv1.conv.out_channels for m in blocks} == {320},
                  "x leg: CFT widths or K2 widths differ from 320/640/1280 "
                  "and 320")
        out = infer(rgb, ir)
        vals = [out] if args.no_nms else [out.boxes, out.scores]
        check(all(bool(torch.isfinite(v).all()) for v in vals),
              f"leg {name}: non-finite output")
        x, x2 = (t.permute(0, 3, 1, 2).float() / 255.0 for t in (rgb, ir))
        if name in ("default", "--c3-kernel") or leg is x_leg:
            with torch.inference_mode():
                fwd_ms[name] = graph_ms(lambda: model(x, x2), replays=10)
        if args.tta:
            # the forwards of the three passes (640 px, 544 px flipped,
            # 448 px) on their inputs, with K2 and through the route
            # without the flag
            cl = torch.channels_last
            passes = [((x.flip(-1), x2.flip(-1)) if f else (x, x2), s)
                      for s, f in zip(SCALES, FLIPS)]
            passes = [tuple((_scale_img(t, s) if s != 1.0 else t)
                            .contiguous(memory_format=cl) for t in p)
                      for p, s in passes]
            with torch.inference_mode():
                fwd_ms[name] = graph_ms(
                    lambda: [model(*p) for p in passes], replays=10)
                for m in blocks:
                    m.fits_kernel = False
                fwd_ms[name + " (K2 off)"] = graph_ms(
                    lambda: [model(*p) for p in passes], replays=10)
                for m in blocks:
                    m.fits_kernel = True
            del passes
        if leg is x_leg:
            k2_launches["c3_bottleneck_x"] = got["c3_bottleneck"]
        if name == "--c3-kernel":
            k2_launches["c3_bottleneck"] = got["c3_bottleneck"]
            with torch.inference_mode():
                profile_forward(torch, lambda: model(x, x2), name)
            with torch.inference_mode():
                raw_k = model(x, x2)
                for m in blocks:
                    m.c3_fn = k2.c3_bottleneck_plain
                raw_p = model(x, x2)
            torch.cuda.synchronize()
            worst = max(rel_err(a, b)[0] for a, b in zip(raw_k, raw_p))
            print(f"bench leg {name}: raw head outputs, K2 vs its plain "
                  f"version: rel={worst:.3e} tol={TOL_BF16_MODEL:.1e}")
            check(worst <= TOL_BF16_MODEL, f"K2 forward disagrees: {worst:.3e}")
        print(json.dumps(res))
        print(res["card"])
        results[name] = res
        del model, infer, rgb, ir, out, vals, x, x2, stages, blocks
        torch.cuda.empty_cache()
    print("bench forward, device ms (graph replay): " + ", ".join(
        f"{k} {v:.3f}" for k, v in fwd_ms.items()))
    return results, k2_launches


def phase_eval(torch, device):
    """Phase 5: the test CLI's runs on a synthetic set. Returns the eval
    line's per-run numbers."""
    from multispectral_object_detection_tpu_torch.cli import test_cli
    from multispectral_object_detection_tpu_torch.data.synthetic import (
        make_paired_dataset)
    from multispectral_object_detection_tpu_torch.models.configs import (
        get_config)
    from multispectral_object_detection_tpu_torch.models.model import (
        build_model, init_weights)
    from multispectral_object_detection_tpu_torch.ops.boxes import (
        pairwise_iou, xywh_to_xyxy)
    from multispectral_object_detection_tpu_torch.ops.ds_fusion import (
        fuse_detections)
    from multispectral_object_detection_tpu_torch.ops.nms import batched_nms

    scratch = Path(__file__).resolve().parent / ".scratch"
    scratch.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_eval_", dir=scratch))
    try:
        t0 = time.perf_counter()
        rgb_dir, ir_dir = make_paired_dataset(
            str(root / "data"), n_images=EVAL_IMAGES, nc=1, seed=0,
            img_hw=EVAL_HW)
        cfg = get_config("yolov5l_fusion_transformerx3", nc=1)
        ckpts = []
        for seed in (0, 1):
            m = build_model(cfg, nc=1)
            init_weights(m, torch.Generator().manual_seed(seed))
            ckpts.append(str(root / f"l_seed{seed}.pt"))
            torch.save(m.state_dict(), ckpts[-1])
            del m
        data = {"val_rgb": rgb_dir, "val_ir": ir_dir, "nc": 1,
                "names": ["person"]}
        print(f"eval: {EVAL_IMAGES} PNG pairs at {EVAL_HW[1]}x{EVAL_HW[0]} "
              f"and two l-scale checkpoints written in "
              f"{time.perf_counter() - t0:.1f} s")
        per_forward = {"cft_layernorm": 48, "cft_gemm_bias": 24,
                       "cft_gemm_gelu": 24, "cft_gemm_residual": 48,
                       "cft_attention": 24, "c3_bottleneck": 0}
        batches = -(-EVAL_IMAGES // EVAL_BATCH)
        # run -> (extra flags, checkpoints, forwards per batch)
        runs = {"val": ([], 1, 1), "save-hybrid": (["--save-hybrid"], 1, 1),
                "augment": (["--augment"], 1, 3),
                "ensemble cat": (["--ensemble-mode", "cat"], 2, 2),
                "ensemble ds": (["--ensemble-mode", "ds"], 2, 2),
                "int8": (["--int8"], 1, 1), "speed": (["--task", "speed"], 1, 0)}
        out = {}
        for name, (extra, n_ckpt, fwd_per_batch) in runs.items():
            args = test_cli.parse_args(
                ["--data", "dict", "--weights", *ckpts[:n_ckpt],
                 "--project", str(root / "runs")] + extra)
            args.data = data
            l0 = kernel_launches()
            k3_0 = k3_launches()
            t0 = time.perf_counter()
            res = test_cli.run(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = kernel_launches(l0)
            k3 = k3_launches(k3_0)
            forwards = (3 + 20) if name == "speed" else batches * fwd_per_batch
            want = {k: v * forwards for k, v in per_forward.items()}
            print(f"eval {name}: {wall:.2f} s, {forwards} forwards, "
                  f"launches {got}, K3 {k3}")
            check(got == want, f"eval {name}: launch counts {got} != {want}")
            check(name == "speed" or k3 == batches,
                  f"eval {name}: {k3} K3 launches for {batches} batches")
            if name == "speed":
                check(res["ms_per_image"] > 0, "speed task")
                out[name] = {"ms_per_image": res["ms_per_image"],
                             "s_wall": wall}
                continue
            keys = ("map50", "map", "mp", "mr", "t_infer_ms", "t_nms_ms",
                    "t_match_ms", "nms_candidates", "nms_iterations")
            check(res["seen"] == EVAL_IMAGES,
                  f"eval {name}: seen {res['seen']} != {EVAL_IMAGES}")
            check(all(math.isfinite(float(res[k])) for k in keys),
                  f"eval {name}: non-finite {res}")
            out[name] = {"s_per_image": wall / res["seen"],
                         **{k: res[k] for k in keys}}
            print(f"eval {name}: " + json.dumps(out[name]))
        hyb = out["save-hybrid"]
        check(hyb["map50"] >= EVAL_MIN_HYBRID_MAP
              and hyb["map"] >= EVAL_MIN_HYBRID_MAP,
              f"hybrid mAP50 {hyb['map50']} / mAP {hyb['map']} < "
              f"{EVAL_MIN_HYBRID_MAP}")

        # one eval batch through the kernels and through the plain stack;
        # and what can hold the hybrid mAP below 1: model scores of
        # exactly 1.0 (ranked ahead of the injected labels) and
        # same-class ground truth overlapping above the NMS IoU
        ds, dets_k, dets_p = _eval_batch_kernels_vs_plain(
            torch, device, data, ckpts[0], "eval")
        # NMS at the eval protocol on that batch: host wall against the
        # device time of its kernels
        def nms():
            return batched_nms(dets_k, conf_thres=0.001, iou_thres=0.6,
                               multi_label=True, max_det=300, top_k=30000)

        nms()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            nms()
        torch.cuda.synchronize()
        nms_wall = (time.perf_counter() - t0) / 3 * 1e3
        nms_dev, nms_launches = device_time(torch, nms)
        print(f"eval: NMS at the eval protocol on that batch: {nms_wall:.3f} "
              f"ms per batch from the host, {nms_dev:.3f} ms of device time "
              f"in {nms_launches} kernel launches (torch.profiler)")
        # the Dempster-Shafer combination of two members' outputs, warm
        ds_ms = cuda_ms(lambda: fuse_detections(torch.stack([dets_k, dets_p])),
                        iters=5, warmup=1)
        print(f"eval: Dempster-Shafer fusion of two members' outputs of that "
              f"batch: {ds_ms:.3f} ms")
        out["nms_batch"] = {"wall_ms": nms_wall, "device_ms": nms_dev,
                            "launches": nms_launches, "ds_fusion_ms": ds_ms}
        out["idle_by_span"] = _eval_idle_by_span(torch, device, data,
                                                 ckpts[0])
        saturated = int((dets_k[..., 4] * dets_k[..., 5] >= 1.0).sum())
        overlaps = 0
        for lab in ds.labels:
            b = xywh_to_xyxy(torch.from_numpy(lab[:, 1:5]))
            iou = pairwise_iou(b, b).triu(diagonal=1)
            overlaps += int((iou > 0.6).sum())
        print(f"eval: hybrid mAP50 {hyb['map50']!r}, mAP {hyb['map']!r}; "
              f"model scores of exactly 1.0 in that batch: {saturated}; "
              f"ground-truth pairs overlapping above IoU 0.6: {overlaps}")
        out["save-hybrid"].update(saturated_scores_batch0=saturated,
                                  gt_pairs_iou_above_0_6=overlaps)
        del dets_k, dets_p
        torch.cuda.empty_cache()
        out["jpeg"] = _eval_jpeg(torch, device, root, ckpts[0], per_forward)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _eval_idle_by_span(torch, device, data: dict, ckpt: str) -> dict:
    """One evaluate pass over the test CLI's first two batches under the
    profiler (tools/profile_model.profile): the device's idle ms and the
    host ms by program span (``idle_by_span``)."""
    from multispectral_object_detection_tpu_torch.cli import test_cli
    from multispectral_object_detection_tpu_torch.tools import (
        profile_model as pm)
    from multispectral_object_detection_tpu_torch.train.evaluator import (
        evaluate)

    args = test_cli.parse_args(["--data", "dict", "--weights", ckpt])
    _, fwd = test_cli.build_forward(args, data, device)
    batches = list(test_cli.make_loader(args, data, IMG, 1)[1])[:2]
    res = pm.profile(lambda: evaluate(fwd, batches, 1, device=device),
                     pm.SERVING_KINDS, runs=1, device=device.type)
    print(f"eval: one traced evaluate pass of {len(batches)} batches, "
          f"{res['host_ms']:.3f} ms, device idle {res['idle']:.1%}:\n"
          + pm.spans_table(res["spans"]))
    return {"host_ms": res["host_ms"], "idle": res["idle"],
            "spans": res["spans"]}


def _eval_batch_kernels_vs_plain(torch, device, data: dict, ckpt: str,
                                 what: str) -> tuple:
    """The test CLI's first eval batch of ``data`` through the kernels and
    through the plain stack, decoded outputs within TOL_BF16_MODEL.
    Returns the dataset and both outputs."""
    from multispectral_object_detection_tpu_torch.cli import test_cli
    from multispectral_object_detection_tpu_torch.models.fusion import (
        CrossModalFusion)
    from multispectral_object_detection_tpu_torch.ops import cft_stack as cs

    args = test_cli.parse_args(["--data", "dict", "--weights", ckpt])
    models, fwd = test_cli.build_forward(args, data, device)
    ds, loader = test_cli.make_loader(args, data, IMG, 1)
    batch = next(iter(loader))
    rgb = torch.from_numpy(batch["rgb"]).to(device)
    ir = torch.from_numpy(batch["ir"]).to(device)
    dets_k = fwd(rgb, ir)[0]
    stages = [m for m in models[0].modules()
              if isinstance(m, CrossModalFusion)]
    for m in stages:
        m.stack_fn = cs.fused_cft_stack_plain
    dets_p = fwd(rgb, ir)[0]
    for m in stages:
        m.stack_fn = cs.fused_cft_stack
    torch.cuda.synchronize()
    rel = rel_err(dets_k, dets_p)[0]
    print(f"{what}: decoded outputs of a {tuple(dets_k.shape)} batch at "
          f"{tuple(rgb.shape[1:3])} px, kernels vs plain stack: "
          f"rel={rel:.3e} tol={TOL_BF16_MODEL:.1e}")
    check(rel <= TOL_BF16_MODEL, f"{what} decoded outputs disagree: "
          f"{rel:.3e}")
    return ds, dets_k, dets_p


@contextlib.contextmanager
def _without(*modules):
    """``modules`` made unimportable for the block, as on the card, whether
    they are installed or not."""
    saved = {m: sys.modules.get(m, "absent") for m in modules}
    for m in modules:
        sys.modules[m] = None
    try:
        yield
    finally:
        for m, v in saved.items():
            if v == "absent":
                del sys.modules[m]
            else:
                sys.modules[m] = v


def _eval_jpeg(torch, device, root: Path, ckpt: str, per_forward: dict):
    """Phase 5's JPEG leg: the test CLI (val, the CLI defaults) over
    EVAL_JPEG_PAIRS pairs made of the committed LLVIP-sized fixtures, with
    the labels of the generator and seed that made them, PIL and cv2
    unimportable: the scan's counters (0 corrupt), finite metrics, K1's
    launches per forward and one batch through the kernels against the
    plain stack."""
    from multispectral_object_detection_tpu_torch.cli import test_cli
    from multispectral_object_detection_tpu_torch.data import native
    from multispectral_object_detection_tpu_torch.data.synthetic import (
        make_paired_dataset)

    check(native.jpeg_available(), "no JPEG decoder builds on this machine "
          "(jpeglib.h or CUDA's nvjpeg.h)")
    t0 = time.perf_counter()
    # tools/make_jpeg_fixtures.py: llvip_*_{0,1}.jpg from this generator
    src = make_paired_dataset(str(root / "jpeg_labels"), n_images=2, nc=1,
                              seed=0, img_hw=(1024, 1280))[0]
    labels = sorted(Path(src).parent.joinpath("labels").glob("*.txt"))
    jroot = root / "jpeg"
    for side in ("rgb", "ir"):
        (jroot / side / "images").mkdir(parents=True)
    (jroot / "rgb" / "labels").mkdir()
    for k in range(EVAL_JPEG_PAIRS):
        for side in ("rgb", "ir"):
            shutil.copy(JPEG_DIR / f"llvip_{side}_{k % 2}.jpg",
                        jroot / side / "images" / f"{k:06d}.jpg")
        shutil.copy(labels[k % 2], jroot / "rgb" / "labels" / f"{k:06d}.txt")
    data = {"val_rgb": str(jroot / "rgb" / "images"),
            "val_ir": str(jroot / "ir" / "images"), "nc": 1,
            "names": ["person"]}
    setup = time.perf_counter() - t0
    with _without("PIL", "cv2"):
        args = test_cli.parse_args(["--data", "dict", "--weights", ckpt,
                                    "--project", str(root / "runs")])
        args.data = data
        l0 = kernel_launches()
        t0 = time.perf_counter()
        res = test_cli.run(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = kernel_launches(l0)
        forwards = -(-EVAL_JPEG_PAIRS // EVAL_BATCH)
        want = {k: v * forwards for k, v in per_forward.items()}
        check(got == want, f"eval jpeg: launch counts {got} != {want}")
        ds = _eval_batch_kernels_vs_plain(torch, device, data, ckpt,
                                          "eval jpeg")[0]
    keys = ("map50", "map", "mp", "mr", "t_infer_ms", "t_nms_ms")
    check(ds.scan_counters == {"found": EVAL_JPEG_PAIRS, "missing": 0,
                               "empty": 0, "corrupt": 0},
          f"eval jpeg: scan counters {ds.scan_counters}")
    check(res["seen"] == EVAL_JPEG_PAIRS
          and all(math.isfinite(float(res[k])) for k in keys),
          f"eval jpeg: {res}")
    out = {"backend": native.jpeg_backend(), "pairs": EVAL_JPEG_PAIRS,
           "s_per_image": wall / res["seen"], "s_setup": setup,
           "scan": ds.scan_counters, **{k: res[k] for k in keys}}
    print(f"eval jpeg: {EVAL_JPEG_PAIRS} LLVIP-sized JPEG pairs "
          f"({native.jpeg_backend()}, no PIL, no cv2), {forwards} forwards, "
          f"launches {got}: " + json.dumps(out))
    torch.cuda.empty_cache()
    return out


def _label_lines(boxes, classes, h0, w0):
    """The detect CLI's --save-txt lines of one image (cls, normalised
    xywh, as its labels/<stem>.txt)."""
    lines = []
    for b, c in zip(boxes, classes):
        cx, cy = (b[0] + b[2]) / 2 / w0, (b[1] + b[3]) / 2 / h0
        bw, bh = (b[2] - b[0]) / w0, (b[3] - b[1]) / h0
        lines.append(" ".join(str(v) for v in (int(c), cx, cy, bw, bh)))
    return lines


def _close_lines(got, want, tol):
    """Label lines equal in count and class, values within tol."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        g, w = g.split(), w.split()
        if g[0] != w[0] or max(abs(float(a) - float(b))
                               for a, b in zip(g[1:], w[1:])) > tol:
            return False
    return True


def _jpeg_variants(root: Path, det) -> dict:
    """Phase 6: the variant fixtures (EXIF orientations 1-8, a big-endian
    EXIF block, progressive, gray, CMYK) through ``imread`` against
    cv2.imread's stored decodes (CMYK: its decode, or a refusal that names
    it); and an orientation-6 pair through ``Detector.__call__`` against
    the same pixels served pre-rotated as PNG."""
    import numpy as np

    from multispectral_object_detection_tpu_torch.data.imageio import (
        imread, write_png)

    vdir = JPEG_DIR / "variants"
    ref = np.load(vdir / "decode.npz")
    out = {}
    for p in sorted(vdir.glob("*.jpg")):
        try:
            img = imread(p)
        except ValueError as e:
            check(p.stem == "cmyk" and "CMYK JPEG" in str(e),
                  f"{p.name}: {e}")
            out[p.stem] = {"refused": str(e)}
            continue
        want = ref[p.stem]
        check(img.shape == want.shape, f"{p.name}: shape {img.shape} != "
              f"cv2's {want.shape}")
        d = np.abs(img.astype(int) - want.astype(int))
        out[p.stem] = {"mean_abs_diff": float(d.mean()),
                       "max_abs_diff": float(d.max())}
    worst = max(v.get("mean_abs_diff", 0.0) for v in out.values())
    print("jpeg variants through imread vs cv2.imread's decodes: "
          + ", ".join(f"{k} " + (f"{v['mean_abs_diff']:.4f}/"
                                 f"{v['max_abs_diff']:.0f}" if "refused"
                                 not in v else "refused")
                      for k, v in out.items())
          + f" (mean/max |d|; bound: mean < {JPEG_MEAN_TOL})")
    check(worst < JPEG_MEAN_TOL, f"a variant decode differs from cv2's: "
          f"mean {worst}")
    jpgs = [str(vdir / "orient_6.jpg"), str(vdir / "orient_6_mm.jpg")]
    pngs = []
    for path, side in zip(jpgs, ("rgb", "ir")):
        pngs.append(str(root / f"rotated_{side}.png"))
        write_png(pngs[-1], imread(path))
    a, b = det(jpgs[:1], jpgs[1:]), det(pngs[:1], pngs[1:])
    diff = float(np.abs(a.boxes[0] - b.boxes[0]).max(initial=0.0)) \
        if a.boxes[0].shape == b.boxes[0].shape else float("inf")
    check(a.images[0].shape == (48, 32, 3) and len(a.boxes[0]) > 0
          and np.array_equal(a.classes[0], b.classes[0]) and diff <= 1e-3,
          f"orientation-6 pair: {a.images[0].shape}, {len(a.boxes[0])} vs "
          f"{len(b.boxes[0])} boxes, max |d| {diff}")
    print(f"Detector.__call__ on an orientation-6 JPEG pair (48x32 stored, "
          f"32x48 served): {len(a.boxes[0])} boxes, max |d| {diff:.2e} px "
          f"from the same pixels served pre-rotated as PNG")
    out["orient_6_detector"] = {"boxes": len(a.boxes[0]),
                                "max_abs_diff_px": diff}
    return out


def phase_serving(torch, device):
    """Phase 6: the serving path: Detector.__call__ on FLIR- and
    LLVIP-sized pairs, the device letterbox against the host one, the
    detect CLI on PNG and JPEG sets, the JPEG decode against cv2's, and the
    REST service on loopback. Returns the serving line's numbers."""
    import statistics
    import threading
    import urllib.request

    import numpy as np

    from multispectral_object_detection_tpu_torch.cli import detect_cli
    from multispectral_object_detection_tpu_torch.data import native
    from multispectral_object_detection_tpu_torch.data.augment import (
        letterbox)
    from multispectral_object_detection_tpu_torch.data.imageio import imread
    from multispectral_object_detection_tpu_torch.data.synthetic import (
        make_paired_dataset)
    from multispectral_object_detection_tpu_torch.hub import Detector
    from multispectral_object_detection_tpu_torch.models.configs import (
        get_config)
    from multispectral_object_detection_tpu_torch.models.model import (
        build_model, init_weights)
    from multispectral_object_detection_tpu_torch.ops.preprocess import (
        letterbox_batch)
    from multispectral_object_detection_tpu_torch.serve import rest_api
    from multispectral_object_detection_tpu_torch.utils.general import (
        apply_classifier, rescale_to_native)

    per_forward = {"cft_layernorm": 48, "cft_gemm_bias": 24,
                   "cft_gemm_gelu": 24, "cft_gemm_residual": 48,
                   "cft_attention": 24, "c3_bottleneck": 0}

    mark = {}

    def reset():
        mark["launches"] = kernel_launches()

    def counted(forwards, what):
        torch.cuda.synchronize()
        got = kernel_launches(mark["launches"])
        want = {k: v * forwards for k, v in per_forward.items()}
        check(got == want, f"{what}: launch counts {got} != {want}")
        return sum(got.values())

    scratch = Path(__file__).resolve().parent / ".scratch"
    scratch.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_", dir=scratch))
    out = {}
    try:
        t0 = time.perf_counter()
        sets = {name: make_paired_dataset(str(root / name),
                                          n_images=SERVE_BATCH, nc=1,
                                          seed=3, img_hw=hw)
                for name, hw in SERVE_SIZES.items()}
        m = build_model(get_config("yolov5l_fusion_transformerx3", nc=1),
                        nc=1)
        init_weights(m, torch.Generator().manual_seed(0))
        ckpt = str(root / "l_seed0.pt")
        torch.save(m.state_dict(), ckpt)
        del m
        det = Detector("yolov5l_fusion_transformerx3", nc=1, weights=ckpt,
                       img_size=IMG, conf=SERVE_CONF, dtype=torch.bfloat16,
                       device=device)
        print(f"serving: {SERVE_BATCH} PNG pairs at each of "
              f"{list(SERVE_SIZES.values())} (h, w) and an l-scale .pt "
              f"written, Detector built, in {time.perf_counter() - t0:.1f} s")

        # Detector.__call__ at each native size
        for name, (rgb_dir, ir_dir) in sets.items():
            rgb_p = sorted(str(p) for p in Path(rgb_dir).glob("*.png"))
            ir_p = sorted(str(p) for p in Path(ir_dir).glob("*.png"))
            det(rgb_p, ir_p)  # first use of this batch's shapes
            reset()
            res = det(rgb_p, ir_p)
            launches = counted(1, f"Detector.__call__ {name}")
            parts = {"prepare": [], "infer": [], "results": []}
            for _ in range(SERVE_REPEATS):
                ta = time.perf_counter()
                rgb, ir, meta, raw = det.prepare(rgb_p, ir_p)
                tb = time.perf_counter()
                d = det.infer(rgb, ir)
                torch.cuda.synchronize()
                tc = time.perf_counter()
                det.results(d, meta, raw)
                td = time.perf_counter()
                for k, v in zip(parts, (tb - ta, tc - tb, td - tc)):
                    parts[k].append(1e3 * v)
            ms = {k: statistics.median(v) for k, v in parts.items()}
            # the same letterboxed batch through Detector.infer, rescaled
            # here by the evaluator's rescale
            boxes, scores, classes, valid = (t.cpu().numpy()
                                             for t in det.infer(rgb, ir))
            n_det = [len(b) for b in res.boxes]
            check(sum(n_det) > 0, f"{name}: no detections at conf "
                  f"{SERVE_CONF}")
            worst = 0.0
            for i, (hw0, ratio, pad) in enumerate(meta):
                b = rescale_to_native(boxes[i][valid[i]], (IMG, IMG), hw0,
                                      (ratio, pad))
                check(b.shape == res.boxes[i].shape and np.array_equal(
                    classes[i][valid[i]], res.classes[i]),
                      f"{name}: image {i} detections differ from infer's")
                worst = max(worst, float(np.abs(b - res.boxes[i]).max(
                    initial=0.0)))
                check(bool(np.isfinite(res.boxes[i]).all()) and
                      (res.boxes[i][:, [0, 2]] <= hw0[1]).all() and
                      (res.boxes[i][:, [1, 3]] <= hw0[0]).all(),
                      f"{name}: boxes outside the native image")
            check(worst <= 1e-3, f"{name}: boxes differ from infer's, "
                  f"rescaled, by {worst} px")
            h, w = SERVE_SIZES[name]
            print(f"serving {name} {w}x{h}, {SERVE_BATCH} pairs per call: "
                  f"{launches} kernel launches in one call (K1 168); ms "
                  f"per call (median of {SERVE_REPEATS}): host decode + "
                  f"letterbox {ms['prepare']:.3f}, forward + NMS "
                  f"{ms['infer']:.3f}, rescale {ms['results']:.3f}; "
                  f"detections per image {n_det}; vs infer rescaled: "
                  f"max |d| {worst:.2e} px")
            out[f"call_{name}"] = {
                "ms_prepare": ms["prepare"], "ms_forward_nms": ms["infer"],
                "ms_rescale": ms["results"],
                "pairs_per_s": SERVE_BATCH * 1e3 / sum(ms.values()),
                "k1_launches": launches, "detections": sum(n_det)}

        # the second-stage classifier filter on the last call's first image,
        # a seeded stand-in classifier (a projection of each crop's mean
        # colour onto 2 classes)
        proj = np.random.default_rng(0).standard_normal((3, 2))
        crops = []

        def classify(ims):
            crops.append(ims)
            return ims.mean(axis=(1, 2)) @ proj

        t0 = time.perf_counter()
        keep = apply_classifier(res.boxes[0], res.classes[0], raw[0],
                                classify)
        cls_ms = 1e3 * (time.perf_counter() - t0)
        n = len(res.boxes[0])
        check(n > 0 and keep.shape == (n,) and keep.dtype == bool
              and crops[0].shape == (n, 224, 224, 3)
              and bool(np.isfinite(crops[0]).all())
              and 0 <= crops[0].min() <= crops[0].max() <= 1,
              f"apply_classifier: {n} boxes, mask {keep.shape}")
        print(f"apply_classifier: {n} boxes of a served LLVIP-sized image "
              f"cut out, resized to 224 and classified in {cls_ms:.1f} ms; "
              f"{int(keep.sum())} kept")
        out["apply_classifier"] = {"boxes": n, "kept": int(keep.sum()),
                                   "ms": cls_ms}

        # the device letterbox against the host one, LLVIP-sized batch
        raws = np.stack(raw)
        t0 = time.perf_counter()
        host = np.stack([letterbox(r, (IMG, IMG))[0] for r in raw])
        host_ms = 1e3 * (time.perf_counter() - t0)
        x = torch.from_numpy(raws).to(device)
        dev = letterbox_batch(x, IMG, normalize=False)
        diff = (dev.cpu().numpy() - host.astype(np.float32))
        dev_ms = cuda_ms(lambda: letterbox_batch(x, IMG, normalize=False),
                         iters=10, warmup=2)
        up_ms = cuda_ms(lambda: letterbox_batch(
            torch.from_numpy(raws).to(device), IMG, normalize=False),
            iters=5, warmup=1)
        mean_d, max_d = float(np.abs(diff).mean()), float(np.abs(diff).max())
        print(f"letterbox of {raws.shape[0]} pairs' RGB at "
              f"{raws.shape[2]}x{raws.shape[1]}: host (C++) {host_ms:.3f} ms, "
              f"device {dev_ms:.3f} ms ({up_ms:.3f} ms with the upload); "
              f"device vs host mean |d| {mean_d:.4f}, max {max_d:.4f} "
              f"(0-255; bound: mean < 1)")
        check(mean_d < 1.0, f"device letterbox differs: mean {mean_d}")
        out["letterbox_llvip"] = {"host_ms": host_ms, "device_ms": dev_ms,
                                  "device_with_upload_ms": up_ms,
                                  "mean_abs_diff": mean_d,
                                  "max_abs_diff": max_d}

        # JPEG: the committed fixtures against cv2's decode
        check(native.jpeg_available(), "no JPEG decoder builds on this "
              "machine (jpeglib.h or CUDA's nvjpeg.h)")
        ref = np.load(JPEG_DIR / "decode.npz")
        worst_mean = worst_max = 0.0
        for p in sorted(JPEG_DIR.glob("*.jpg")):
            img = native.decode_jpeg(p.read_bytes())
            for got, want in ((img[::8, ::8], ref[f"{p.stem}_sub"]),) + (
                    ((img, ref["small_rgb"]),) if p.stem == "small_rgb"
                    else ()):
                check(got.shape == want.shape, f"{p.name}: shape")
                d = np.abs(got.astype(int) - want.astype(int))
                worst_mean = max(worst_mean, float(d.mean()))
                worst_max = max(worst_max, float(d.max()))
        print(f"jpeg: {native.jpeg_backend()} decode of the 6 fixtures "
              f"vs cv2's: worst "
              f"mean |d| {worst_mean:.4f}, max |d| {worst_max:.0f} "
              f"(bound: mean < {JPEG_MEAN_TOL}; 0 = cv2's pixels)")
        check(worst_mean < JPEG_MEAN_TOL, "JPEG decode differs from cv2")
        out["jpeg_decode"] = {"backend": native.jpeg_backend(),
                              "mean_abs_diff": worst_mean,
                              "max_abs_diff": worst_max}
        out["jpeg_variants"] = _jpeg_variants(root, det)
        jroot = root / "jpeg"
        for side in ("rgb", "ir"):
            (jroot / side).mkdir(parents=True)
            for k in range(SERVE_BATCH):
                shutil.copy(JPEG_DIR / f"llvip_{side}_{k % 2}.jpg",
                            jroot / side / f"{k:06d}.jpg")
        cli_sets = {"png": sets["llvip"],
                    "jpeg": (str(jroot / "rgb"), str(jroot / "ir"))}

        # the detect CLI, headless and saving, against Detector.__call__:
        # LLVIP's frame shrinks by exactly 2 to 640 px, where the headless
        # load's INTER_AREA and the letterbox's INTER_LINEAR (cv2's, and
        # the port's) give the same pixels, so all label files agree
        for kind, (rgb_dir, ir_dir) in cli_sets.items():
            files = sorted(Path(rgb_dir).iterdir())
            irs = sorted(Path(ir_dir).iterdir())
            want = det([str(p) for p in files], [str(p) for p in irs])
            for leg, extra in (("headless", ["--nosave"]), ("save", [])):
                args = detect_cli.parse_args(
                    ["--weights", ckpt, "--source1", rgb_dir, "--source2",
                     ir_dir, "--nc", "1", "--img-size", str(IMG),
                     "--conf-thres", str(SERVE_CONF), "--save-txt",
                     "--batch-size", str(SERVE_BATCH), "--device",
                     str(device), "--project", str(root / "runs"),
                     "--name", f"{kind}_{leg}"] + extra)
                reset()
                t0 = time.perf_counter()
                r = detect_cli.run(args)
                wall = time.perf_counter() - t0
                launches = counted(1, f"detect CLI {kind} {leg}")
                check(r["n_images"] == SERVE_BATCH and r["n_det"] > 0,
                      f"detect CLI {kind} {leg}: {r}")
                same = exact = 0
                for i, p in enumerate(files):
                    got = (Path(r["save_dir"]) / "labels" /
                           f"{p.stem}.txt").read_text().splitlines()
                    ref_lines = _label_lines(want.boxes[i], want.classes[i],
                                             *want.images[i].shape[:2])
                    exact += got == ref_lines
                    same += _close_lines(got, ref_lines, 1e-6)
                check(same == len(files), f"detect CLI {kind} {leg}: "
                      f"{len(files) - same} label files differ from "
                      f"Detector.__call__'s")
                written = len(list(Path(r["save_dir"]).glob("*_rgb.*")))
                check(written == (0 if leg == "headless" else SERVE_BATCH),
                      f"detect CLI {kind} {leg}: {written} images written")
                h, w = want.images[0].shape[:2]
                print(f"detect CLI {kind} {leg} ({SERVE_BATCH} pairs "
                      f"{w}x{h}, --batch-size {SERVE_BATCH}): fps "
                      f"{r['fps']:.2f}, fps_steady {r['fps_steady']:.2f} "
                      f"(one batch: steady = end to end), {r['n_det']} "
                      f"detections, {launches} kernel launches (K1 168), "
                      f"{wall:.1f} s with the model build; label files as "
                      f"Detector.__call__'s: {same}/{len(files)} (byte for "
                      f"byte: {exact})")
                out[f"cli_{kind}_{leg}"] = {
                    "fps": r["fps"], "fps_steady": r["fps_steady"],
                    "n_det": r["n_det"], "s_with_build": wall}
                torch.cuda.empty_cache()

        # REST on loopback: one PNG pair and one JPEG pair
        server = rest_api.make_server(det, "cft", "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            url = (f"http://127.0.0.1:{server.server_address[1]}"
                   "/v1/object-detection/cft")
            for kind, (rgb_dir, ir_dir) in cli_sets.items():
                pr, pi = (sorted(Path(d).iterdir())[0] for d in (rgb_dir,
                                                                 ir_dir))
                ctype, body = rest_api.encode_multipart(
                    {"image": (pr.name, pr.read_bytes()),
                     "image_ir": (pi.name, pi.read_bytes())})
                def post():
                    req = urllib.request.Request(
                        url, data=body, headers={"Content-Type": ctype})
                    with urllib.request.urlopen(req, timeout=300) as resp:
                        return resp.status, json.loads(resp.read())

                first = post()  # the first pass at batch 1 pays first uses
                reset()
                t0 = time.perf_counter()
                status, got = post()
                rest_ms = 1e3 * (time.perf_counter() - t0)
                counted(1, f"REST {kind}")
                check(first == (status, got), f"REST {kind}: two requests "
                      f"of one pair answered differently")
                want = det([imread(pr)], [imread(pi)]).records()[0]
                check(status == 200 and got == want and len(got) > 0,
                      f"REST {kind}: {status}, {len(got)} records, equal to "
                      f"Detector.__call__'s: {got == want}")
                print(f"REST {kind}: 200, {len(got)} records equal to "
                      f"Detector.__call__'s, {rest_ms:.1f} ms for the second "
                      f"request (decode, letterbox, batch-1 forward, NMS, "
                      f"JSON)")
                out[f"rest_{kind}_ms"] = rest_ms
        finally:
            server.shutdown()
            server.server_close()
            thread.join()
        del det
        torch.cuda.empty_cache()
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def k2_library(x, w1, b1, w2, b2):
    """K2's function as the port computes it without the flag, on cuDNN:
    conv(+b1) -> SiLU -> conv(+b2) -> SiLU -> + x, NCHW channels_last. Its
    arguments from K2's (NHWC x, w1 (C, C), w2 (9, C, C))."""
    import torch
    import torch.nn.functional as F

    C = x.shape[-1]
    cl = torch.channels_last
    xc = x.permute(0, 3, 1, 2)
    wa = w1.t().reshape(C, C, 1, 1).contiguous(memory_format=cl)
    wb = w2.reshape(3, 3, C, C).permute(3, 2, 0, 1).contiguous(memory_format=cl)
    return lambda: xc + F.silu(F.conv2d(F.silu(F.conv2d(xc, wa, b1)), wb, b2,
                                        padding=1))


def _gemm_cost(Mr, K, Nout, residual):
    by = 2 * (Mr * K + K * Nout + Nout) + (8 if residual else 2) * Mr * Nout
    return by, 2 * Mr * K * Nout + Mr * Nout


def phase_timing(torch, F, cs, k2, device, det, batches, stages, card):
    """Phase 7: kernel rows (per forward of the main paths) and end to end."""
    from multispectral_object_detection_tpu_torch.ops.nms import batched_nms

    gen = torch.Generator().manual_seed(2)

    def new_row():
        return {"ms": 0.0, "eager_ms": 0.0, "plain_ms": 0.0,
                "library_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                "bound_ms": 0.0, "ops": 0.0, "by_c": {}}

    rows = {k: new_row() for k in KERNELS if k != "c3_bottleneck_x"}
    # LayerNorm and attention at the x scale's P5 stage (x@1024 bs8)
    xrows = {"cft_layernorm": new_row(), "cft_attention": new_row()}
    bf = torch.bfloat16

    def add(r, C, fn_k, fn_p, fn_lib, costs, kind):
        """Device times (graph replay) of one forward's launches of a
        kernel at width C, its plain twin and the library call; its
        host-launched time."""
        r["by_c"][C] = graph_ms(fn_k)
        r["ms"] += r["by_c"][C]
        r["eager_ms"] += cuda_ms(fn_k)
        r["plain_ms"] += graph_ms(fn_p)
        r["library_ms"] += graph_ms(fn_lib)
        for by, ops in costs:
            tb, to = by / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FLOPS[kind] * 1e3
            r["ops"] += ops
            r["bytes_ms"] += tb
            r["ops_ms"] += to
            r["bound_ms"] += max(tb, to)

    def ln_cost(Mr, C):
        return (Mr * C * 4 + Mr * C * 2 + 2 * C * 4, 8 * Mr * C)

    def attn_cost(Bq, C):
        Mr = Bq * N_TOK
        return (Mr * 4 * C * 2, 4 * Mr * N_TOK * C + 5 * Bq * HEADS * N_TOK ** 2)

    for C in STAGE_WIDTHS:
        x, w = stack_inputs(C, bf, gen, device)
        wqkv, bqkv, wp, bp, w1, b1, w2, b2, ln1, ln2 = w
        xs = torch.randn(M, C, generator=gen).to(device)
        h = torch.randn(M, C, generator=gen).to(device, bf)
        t4 = torch.randn(M, 4 * C, generator=gen).to(device, bf)
        qkv = torch.randn(M, 3 * C, generator=gen).to(device, bf)
        ls = range(L)
        add(rows["cft_layernorm"], C,
            lambda: [cs.layer_norm(xs, ln[l, 0], ln[l, 1], bf)
                     for l in ls for ln in (ln1, ln2)],
            lambda: [cs.layer_norm_plain(xs, ln[l, 0], ln[l, 1], bf)
                     for l in ls for ln in (ln1, ln2)],
            lambda: [F.layer_norm(xs, (C,), ln[l, 0], ln[l, 1], 1e-5)
                     for l in ls for ln in (ln1, ln2)],
            [ln_cost(M, C)] * (2 * L), "fp32")
        add(rows["cft_gemm_bias"], C,
            lambda: [cs.linear(h, wqkv[l], bqkv[l], "bias") for l in ls],
            lambda: [cs.linear_plain(h, wqkv[l], bqkv[l], "bias") for l in ls],
            lambda: [torch.addmm(bqkv[l], h, wqkv[l]) for l in ls],
            [_gemm_cost(M, C, 3 * C, False)] * L, "bf16")
        add(rows["cft_gemm_gelu"], C,
            lambda: [cs.linear(h, w1[l], b1[l], "gelu") for l in ls],
            lambda: [cs.linear_plain(h, w1[l], b1[l], "gelu") for l in ls],
            lambda: [F.gelu(torch.addmm(b1[l], h, w1[l])) for l in ls],
            [_gemm_cost(M, C, 4 * C, False)] * L, "bf16")
        add(rows["cft_gemm_residual"], C,
            lambda: [(cs.linear(h, wp[l], bp[l], "residual", out=xs),
                      cs.linear(t4, w2[l], b2[l], "residual", out=xs))
                     for l in ls],
            lambda: [(cs.linear_plain(h, wp[l], bp[l], "residual", out=xs),
                      cs.linear_plain(t4, w2[l], b2[l], "residual", out=xs))
                     for l in ls],
            lambda: [(xs.add_(torch.addmm(bp[l], h, wp[l])),
                      xs.add_(torch.addmm(b2[l], t4, w2[l]))) for l in ls],
            [_gemm_cost(M, C, C, True), _gemm_cost(M, 4 * C, C, True)] * L,
            "bf16")
        q, k, v = qkv.view(B, N_TOK, 3, HEADS, C // HEADS).permute(
            2, 0, 3, 1, 4).unbind(0)
        add(rows["cft_attention"], C,
            lambda: [cs.attention(qkv, B, HEADS) for _ in ls],
            lambda: [cs.attention_plain(qkv, B, HEADS) for _ in ls],
            lambda: [F.scaled_dot_product_attention(q, k, v) for _ in ls],
            [attn_cost(B, C)] * L, "bf16")

    # x scale, P5 stage: C = 1280, head width 160, 8 images of 128 tokens
    Bx, C = 8, X_P5
    Mx = Bx * N_TOK
    ln1 = stack_inputs(C, bf, gen, device)[1][8]
    xs = torch.randn(Mx, C, generator=gen).to(device)
    qkv = torch.randn(Mx, 3 * C, generator=gen).to(device, bf)
    q, k, v = qkv.view(Bx, N_TOK, 3, HEADS, C // HEADS).permute(
        2, 0, 3, 1, 4).unbind(0)
    add(xrows["cft_layernorm"], C,
        lambda: [cs.layer_norm(xs, ln1[l % L, 0], ln1[l % L, 1], bf)
                 for l in range(2 * L)],
        lambda: [cs.layer_norm_plain(xs, ln1[l % L, 0], ln1[l % L, 1], bf)
                 for l in range(2 * L)],
        lambda: [F.layer_norm(xs, (C,), ln1[l % L, 0], ln1[l % L, 1], 1e-5)
                 for l in range(2 * L)],
        [ln_cost(Mx, C)] * (2 * L), "fp32")
    add(xrows["cft_attention"], C,
        lambda: [cs.attention(qkv, Bx, HEADS) for _ in range(L)],
        lambda: [cs.attention_plain(qkv, Bx, HEADS) for _ in range(L)],
        lambda: [F.scaled_dot_product_attention(q, k, v) for _ in range(L)],
        [attn_cost(Bx, C)] * L, "bf16")

    # K2: the 42 blocks of one l@640 bs16 forward with --c3-kernel, and the
    # 24 of one x@1024 bs8 forward, each block on inputs of its own (no L2
    # reuse between blocks); both launches together, then each apart
    xrows["c3_bottleneck"] = new_row()
    k2_split = {}  # C -> blocks, 1x1 and 3x3 ms, their bounds, 3x3 TFLOP/s
    for shape, n in K2_BLOCKS + ((K2_X_SHAPE, K2_X_BLOCKS),):
        row = xrows if shape == K2_X_SHAPE else rows
        blocks = [k2_inputs(shape, bf, bf, gen, device) for _ in range(n)]
        libs = [k2_library(*b) for b in blocks]
        P, C = shape[0] * shape[1] * shape[2], shape[3]
        cost = (2 * (2 * P * C + 10 * C * C + 2 * C), 20 * P * C * C)
        add(row["c3_bottleneck"], C,
            lambda: [k2.c3_bottleneck(*b) for b in blocks],
            lambda: [k2.c3_bottleneck_plain(*b) for b in blocks],
            lambda: [f() for f in libs], [cost] * n, "bf16")
        zs = [torch.empty_like(b[0]) for b in blocks]
        outs = [torch.empty_like(b[0]) for b in blocks]
        ms1 = graph_ms(lambda: [k2.c3_conv(x, w1, b1, None, z, 1) for
                                (x, w1, b1, _, _), z in zip(blocks, zs)])
        ms9 = graph_ms(lambda: [k2.c3_conv(z, w2, b2, x, o, 9) for
                                (x, _, _, w2, b2), z, o in
                                zip(blocks, zs, outs)])
        # per launch: the 1x1 reads x and writes z, the 3x3 reads z and x
        # and writes y
        bound1 = n * max(2 * (2 * P * C + C * C + C) / PEAK_BYTES_PER_S,
                         2 * P * C * C / PEAK_FLOPS["bf16"]) * 1e3
        bound9 = n * max(2 * (3 * P * C + 9 * C * C + C) / PEAK_BYTES_PER_S,
                         18 * P * C * C / PEAK_FLOPS["bf16"]) * 1e3
        k2_split[C] = (n, ms1, ms9, bound1, bound9,
                       n * 18 * P * C * C / ms9 / 1e9)
        del blocks, libs, zs, outs
    torch.cuda.synchronize()
    # the two-launch design's own floor: it also writes z, reads it back and
    # reads x a second time for the residual
    floor_2l = 0.0
    for shape, n in K2_BLOCKS:
        P, C = shape[0] * shape[1] * shape[2], shape[3]
        floor_2l += n * max(2 * (5 * P * C + 10 * C * C + 2 * C)
                            / PEAK_BYTES_PER_S, 20 * P * C * C
                            / PEAK_FLOPS["bf16"]) * 1e3
    print(f"timing on: {card}")
    print("per forward (3 stages x 8 layers; K2: 42 blocks), device ms from "
          "CUDA-graph replay; eager = launched from the host one by one")
    print("kernel              ms/fwd  eager_ms   plain_ms  library_ms  "
          "bound_ms bound_by   TFLOP/s  of bound")
    for name, r in list(rows.items()) + [(f"x {k}", r) for k, r in
                                         xrows.items()]:
        r["bound_by"] = "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations"
        print(f"{name:<18} {r['ms']:8.4f} {r['eager_ms']:9.4f} "
              f"{r['plain_ms']:10.4f} {r['library_ms']:11.4f} "
              f"{r['bound_ms']:9.4f} {r['bound_by']:<10} "
              f"{r['ops'] / r['ms'] / 1e9:8.1f} {r['bound_ms'] / r['ms']:8.1%}")
    print("(x rows: LayerNorm and attention at the x scale's P5 stage at "
          "x@1024 bs8, C=1280, head width 160; K2 over the 24 blocks of one "
          "x@1024 bs8 forward, C=320)")
    print("device ms per stage, C = " + " / ".join(map(str, STAGE_WIDTHS)))
    for name, r in rows.items():
        print(f"{name:<18} " + " / ".join(f"{r['by_c'][C]:.4f}"
                                          for C in r["by_c"]))
    print(f"(K2 by block class C = 64 / 128 / 256, 6 / 18 / 18 blocks.) "
          f"The two-launch design's own floor, with z written and read back "
          f"and x read twice: {floor_2l:.4f} ms per forward")
    print("K2 per launch, device ms per forward (graph replay): "
          "C blocks  1x1_ms  bound  3x3_ms  bound  3x3_TFLOP/s")
    for C, (n, ms1, ms9, b1, b9, tf) in k2_split.items():
        print(f"  K2 C={C:<4} x{n:<3} {ms1:8.4f} {b1:7.4f} {ms9:8.4f} "
              f"{b9:7.4f} {tf:8.1f}")
    # end to end: one request of BATCH pairs already on the card
    rgb, ir = batches[0]
    ms_infer = cuda_ms(lambda: det.infer(rgb, ir), iters=10, warmup=2)
    raw = det.raw(rgb, ir)
    ms_post = cuda_ms(lambda: batched_nms(det.model.decode(raw), max_det=300,
                                          top_k=1024), iters=10, warmup=2)
    ms_fwd = cuda_ms(lambda: det.raw(rgb, ir), iters=10, warmup=2)
    ms_fwd_dev = graph_ms(lambda: det.raw(rgb, ir), replays=10)
    for m in stages:
        m.stack_fn = cs.fused_cft_stack_plain
    ms_fwd_plain = cuda_ms(lambda: det.raw(rgb, ir), iters=5, warmup=1)
    ms_fwd_plain_dev = graph_ms(lambda: det.raw(rgb, ir), replays=5)
    for m in stages:
        m.stack_fn = cs.fused_cft_stack
    # diagnostic for the conv trunk: the same forward with cuDNN autotuning
    torch.backends.cudnn.benchmark = True
    ms_fwd_tuned_dev = graph_ms(lambda: det.raw(rgb, ir), replays=10)
    torch.backends.cudnn.benchmark = False
    stack_ms = sum(r["ms"] for k, r in rows.items() if k.startswith("cft_"))
    print(f"main path (bf16, bs{BATCH}, {IMG} px) on {card}: "
          f"{ms_infer:.3f} ms/batch = {BATCH * 1e3 / ms_infer:.1f} pairs/s")
    print(f"  forward {ms_fwd:.3f} ms launched from the host, {ms_fwd_dev:.3f}"
          f" ms of device time (graph replay; device idle "
          f"{1 - ms_fwd_dev / ms_fwd:.1%}); CFT kernels {stack_ms:.3f} ms of "
          f"it; decode+NMS {ms_post:.3f} ms")
    print(f"  forward with the plain stack: {ms_fwd_plain:.3f} ms from the "
          f"host, {ms_fwd_plain_dev:.3f} ms device")
    print(f"  forward with cudnn.benchmark on: {ms_fwd_tuned_dev:.3f} ms "
          "device")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB")
    profile_forward(torch, lambda: det.raw(rgb, ir), "Detector")
    return rows, xrows


def device_time(torch, fn) -> tuple[float, int]:
    """Device ms and kernel launches of one call of fn (torch.profiler,
    through tools/profile_model.py)."""
    from multispectral_object_detection_tpu_torch.tools import (
        profile_model as pm)

    res = pm.profile(fn, pm.SERVING_KINDS, runs=1, warmup=0)
    return res["device_ms"], res["launches"]


def profile_forward(torch, fn, label: str, runs: int = 2) -> dict:
    """Device time of the forward by kind of operation (torch.profiler,
    through tools/profile_model.py)."""
    from multispectral_object_detection_tpu_torch.tools import (
        profile_model as pm)

    res = pm.profile(fn, pm.SERVING_KINDS, runs=runs)
    print(f"profile of the {label} forward (torch.profiler, {runs} runs): "
          f"{res['device_ms']:.3f} ms of kernels per forward; "
          + pm.kinds_line(res))
    for name, ms, n in res["kernels"][:8]:
        print(f"  {ms / runs:8.3f} ms x{n // runs:<4} {name[:90]}")
    return res


# training phase: the mini model of the card-vs-CPU step, the full-width
# steps, and the train CLI's run
TRAIN_MINI_IMG, TRAIN_MINI_BATCH = 128, 2
TRAIN_IMG, TRAIN_BATCH, TRAIN_STEPS = 640, 8, 20
TRAIN_CLI_IMAGES = 16
# fp32 card vs CPU, TF32 off: the same function rounded in another order.
# This random-weight model's gradients move by up to 1e-4 of their largest
# value when its weights move by one part in 1e7 (CPU measurement at 128 px,
# batch 2), so a few times that; gradients that are analytically zero (the
# key projection's bias: softmax is shift-invariant) are held against
# 1e-3 of the largest gradient of the model
TOL_TRAIN_LOSS = 1e-5
TOL_TRAIN_GRAD = 1e-3
# one bf16 step with remat none and blocks: the same forward ops, so the
# loss and the BatchNorm statistics agree up to cuDNN's choice of algorithm
TOL_REMAT = 1e-3


def _grad_errors(grads, refs) -> list:
    """Per tensor max|got - ref| / max(max|ref|, 1e-3 * the largest |ref|
    of all tensors)."""
    big = max(float(r.abs().max()) for r in refs)
    return [float((g.cpu() - r).abs().max())
            / max(float(r.abs().max()), 1e-3 * big) for g, r in
            zip(grads, refs)]


def _mini_step_grads(torch, device, weights, batch):
    """One fp32 train-mode forward + loss + gradients of the n-scale
    two-stream CFT (nc=2), dropout off, on ``device``."""
    from multispectral_object_detection_tpu_torch.models import configs
    from multispectral_object_detection_tpu_torch.models.detect import (
        anchor_arrays)
    from multispectral_object_detection_tpu_torch.models.fusion import (
        CrossModalFusion)
    from multispectral_object_detection_tpu_torch.models.model import (
        build_model)
    from multispectral_object_detection_tpu_torch.train.loss import (
        DetectionLoss)

    model = build_model(configs.yolov5_two_stream("n", nc=2,
                                                  fusion="transformerx3"))
    model.load_state_dict(weights)
    for m in model.modules():
        if isinstance(m, CrossModalFusion):
            m.embd_drop = m.attn_drop = m.resid_drop = 0.0
    model = model.to(device).train()
    loss_fn = DetectionLoss(2, anchor_arrays(model.spec.anchors),
                            model.spec.strides)
    rgb, ir, tg, tm = (torch.from_numpy(a).to(device) for a in batch)
    xs = [t.permute(0, 3, 1, 2).float() / 255.0 for t in (rgb, ir)]
    total, comps = loss_fn(model(*xs), tg, tm)
    params = list(model.parameters())
    grads = torch.autograd.grad(total, params)
    return float(total), [g.detach().cpu() for g in grads]


def _remat_one_step(torch, device, remat: str, batch):
    """One bf16 step of the l model with ``remat``; the loss and the
    BatchNorm running statistics after it."""
    from multispectral_object_detection_tpu_torch import bench_train

    args = bench_train.parse_args(["--remat", remat, "--img",
                                   str(TRAIN_IMG), "--batch",
                                   str(TRAIN_BATCH)])
    state, step, _ = bench_train.prepare(args)
    m = step(*batch, seed=0)
    stats = {k: v.float().clone() for k, v in state.model.state_dict().items()
             if "running_" in k}
    grads = {}
    if remat == "none":  # the gradients the optimizer got, by name
        seen = []
        update = state.opt.update
        state.opt.update = lambda g: (seen.append(list(g)), update(g))[1]
        step(*batch, seed=1)
        grads = dict(zip(state.opt.names, seen[0]))
    total = float(m["total"])
    del state, step
    torch.cuda.empty_cache()
    return total, stats, grads


def _profile_train_steps(torch, step, batch, runs: int = 2) -> dict:
    """Wall time and device busy time of ``runs`` train steps
    (torch.profiler, through tools/profile_model.py), by kind of kernel;
    the idle share is 1 - busy / wall. The profiler's own host cost
    lengthens the wall time a little."""
    from multispectral_object_detection_tpu_torch.tools import (
        profile_model as pm)

    seeds = iter(range(1000, 1001 + runs))  # one more: the profiler's warm-up
    res = pm.profile(lambda: step(*batch, seed=next(seeds)), pm.TRAIN_KINDS,
                     runs=runs, warmup=0)
    print(f"      profile ({runs} steps, torch.profiler): {res['host_ms']:.3f}"
          f" ms per step, {res['device_ms']:.3f} ms of kernels "
          f"({res['launches']} launches), device idle {100 * res['idle']:.1f}"
          f" %; " + pm.kinds_line(res))
    return {"profiled_ms_per_step": res["host_ms"],
            "device_busy_ms": res["device_ms"],
            "launches_per_step": res["launches"],
            "by_kind_ms": {k: v["ms"] for k, v in res["by_kind"].items()}}


def phase_train(torch, device, card: str) -> tuple:
    """Phase 8: training on the card. Returns the numbers for its JSON
    line, and the train CLI's 2-epoch run for phase 11c (see
    ``_train_cli_runs``)."""
    from multispectral_object_detection_tpu_torch import bench_train
    from multispectral_object_detection_tpu_torch.data.synthetic import (
        synthetic_batch)
    from multispectral_object_detection_tpu_torch.models import configs
    from multispectral_object_detection_tpu_torch.models.model import (
        build_model, init_weights)

    t_phase = time.perf_counter()
    out = {"card": card}
    # 1. card against CPU on the mini model, fp32, TF32 off
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        mini = build_model(configs.yolov5_two_stream("n", nc=2,
                                                     fusion="transformerx3"))
        init_weights(mini, torch.Generator().manual_seed(3))
        weights = mini.state_dict()
        batch = synthetic_batch(TRAIN_MINI_BATCH, TRAIN_MINI_IMG, nc=2,
                                max_labels=16, seed=3)
        l_cpu, g_cpu = _mini_step_grads(torch, torch.device("cpu"), weights,
                                        batch)
        l_gpu, g_gpu = _mini_step_grads(torch, device, weights, batch)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    grad_rel = max(_grad_errors(g_gpu, g_cpu))
    print(f"  8.1 mini fp32 step, card vs CPU: loss {l_gpu:.6f} vs "
          f"{l_cpu:.6f} (rel {loss_rel:.3g}), worst gradient rel "
          f"{grad_rel:.3g} [{card}]")
    check(loss_rel <= TOL_TRAIN_LOSS, f"mini step loss rel {loss_rel:.3g}")
    check(grad_rel <= TOL_TRAIN_GRAD, f"mini step gradient rel {grad_rel:.3g}")
    out["mini_loss_rel"], out["mini_grad_rel"] = loss_rel, grad_rel

    # 2. full width: one step under none and blocks, then the bench
    dev_batch = tuple(torch.from_numpy(a).to(device) for a in synthetic_batch(
        TRAIN_BATCH, TRAIN_IMG, 3, 64, seed=0))
    l_none, s_none, grads = _remat_one_step(torch, device, "none", dev_batch)
    l_blk, s_blk, _ = _remat_one_step(torch, device, "blocks", dev_batch)
    d_loss = abs(l_blk - l_none) / abs(l_none)
    d_stats = max(float((s_blk[k] - s_none[k]).abs().max()
                        / s_none[k].abs().max().clamp(min=1e-12))
                  for k in s_none)
    print(f"  8.2 one l@{TRAIN_IMG} bs{TRAIN_BATCH} bf16 step: loss none "
          f"{l_none:.6f} blocks {l_blk:.6f} (rel {d_loss:.3g}); BatchNorm "
          f"statistics after it, worst rel {d_stats:.3g} [{card}]")
    check(d_loss <= TOL_REMAT and d_stats <= TOL_REMAT,
          "remat blocks changed the step's loss or BatchNorm statistics")
    cft = {n: g for n, g in grads.items()
           if ".trans_blocks." in n and n.endswith(".weight")}
    zero = [n for n, g in cft.items()
            if not bool(torch.isfinite(g).all()) or float(g.abs().max()) == 0]
    print(f"  8.2 CFT weights with a nonzero finite gradient: "
          f"{len(cft) - len(zero)} of {len(cft)}")
    check(len(cft) == 3 * 8 * 8 and not zero,
          f"CFT weights without a gradient: {zero[:4]}")
    del grads, cft
    out["remat_loss_rel"], out["remat_stats_rel"] = d_loss, d_stats
    for remat in ("none", "blocks"):
        args = bench_train.parse_args(["--remat", remat, "--img",
                                       str(TRAIN_IMG), "--batch",
                                       str(TRAIN_BATCH), "--steps",
                                       str(TRAIN_STEPS)])
        base = bench_train.allocated(device)
        state, step, batch = bench_train.prepare(args)
        r = bench_train.measure(args, state, step, batch, base_bytes=base)
        prof = _profile_train_steps(torch, step, batch)
        # the step reads nothing back to the host (a CUDA graph could
        # capture it): CUDA's sync debug mode raises on a synchronising call
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(*batch, seed=2000)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        print(f"      one step under CUDA sync debug mode 'error': no host "
              f"sync (remat {remat})")
        del state, step, batch
        losses = r["losses"]
        check(all(math.isfinite(v) for v in losses),
              f"remat {remat}: a loss is not finite")
        k = 5
        falling = sum(losses[-k:]) / k < sum(losses[:k]) / k
        print(f"  8.2 bench_train remat={remat}: {r['ms_per_step']:.3f} ms "
              f"per step ({r['host_ms_per_step']:.3f} ms of it to enqueue "
              f"on the host), {r['images_per_s']:.2f} images/s, peak "
              f"{r['peak_gb']:.2f} GB (state {r['state_gb']:.2f} GB, "
              f"without {base / 1e9:.2f} GB held by earlier phases); loss "
              f"{losses[0]:.4f} -> "
              f"{losses[-1]:.4f} over {len(losses)} steps [{r['card']}]")
        check(falling, f"remat {remat}: the loss did not fall "
              f"({losses[:k]} -> {losses[-k:]})")
        out[remat] = {k2: r[k2] for k2 in ("ms_per_step", "images_per_s",
                                            "peak_gb", "state_gb",
                                            "host_ms_per_step")}
        out[remat].update(prof)
        out[remat]["loss_first_last"] = [losses[0], losses[-1]]
        torch.cuda.empty_cache()
    out["cli"], run = _train_cli_runs(torch, device, card)
    out["seconds"] = time.perf_counter() - t_phase
    return out, run


def _train_cli_runs(torch, device, card: str) -> tuple:
    """Phase 8.3: the train CLI (2 epochs of the l model at 640, batch 8,
    16 synthetic PNG pairs), the stripped checkpoint through the test CLI
    with --compute-loss and the detect CLI's --update, and K1 against its
    plain twin on the trained EMA weights. Returns the numbers and {tmp,
    run, data}: the 2-epoch run, which phase 11c resumes at epoch 2 (its
    temporary directory is removed after phase 11, or here if this phase
    fails)."""
    from multispectral_object_detection_tpu_torch.cli import (detect_cli,
                                                               test_cli,
                                                               train_cli)
    from multispectral_object_detection_tpu_torch.data.datasets import (
        BatchLoader, PairedDetectionDataset)
    from multispectral_object_detection_tpu_torch.data.synthetic import (
        make_paired_dataset)
    from multispectral_object_detection_tpu_torch.models.configs import (
        get_config)
    from multispectral_object_detection_tpu_torch.models.fusion import (
        CrossModalFusion)
    from multispectral_object_detection_tpu_torch.models.model import (
        build_model, load_reference_state_dict)
    from multispectral_object_detection_tpu_torch.ops import cft_stack as cs
    from multispectral_object_detection_tpu_torch.utils.checkpoint import (
        load_inference_params)

    cfg_name = "yolov5l_fusion_transformerx3"
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    out = {}
    try:
        rgb_dir, ir_dir = make_paired_dataset(str(tmp / "data"),
                                              n_images=TRAIN_CLI_IMAGES,
                                              img_size=TRAIN_IMG, nc=2,
                                              seed=7)
        data = {"train_rgb": rgb_dir, "train_ir": ir_dir, "val_rgb": rgb_dir,
                "val_ir": ir_dir, "nc": 2, "names": ["red", "blue"]}
        common = ["--data", "unused", "--cfg", cfg_name, "--img-size",
                  str(TRAIN_IMG), "--batch-size", str(TRAIN_BATCH),
                  "--project", str(tmp / "runs")]

        def train(argv):
            args = train_cli.parse_args(common + argv)
            args.data = data
            return train_cli.run(args)

        l0 = kernel_launches()
        t0 = time.perf_counter()
        r = train(["--epochs", "2", "--name", "exp"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        run = Path(r["save_dir"])
        lines = (run / "results.txt").read_text().splitlines()
        k1 = k1_launches(l0)
        print(f"  8.3 train CLI, 2 epochs of l@{TRAIN_IMG} bs{TRAIN_BATCH} "
              f"over {TRAIN_CLI_IMAGES} pairs in {secs:.1f} s [{card}]")
        for ln in lines:
            print(f"      {ln}")
        check(len(lines) == 2 and all("mAP50" in ln for ln in lines),
              "results.txt lacks an epoch's eval")
        check(r["eval_forwards"] > 0 and k1 == 168 * r["eval_forwards"],
              f"K1 launches {k1} != 168 x {r['eval_forwards']} eval forwards")
        check(kernel_launches(l0)["c3_bottleneck"] == 0,
              "K2 launched in training")
        print(f"  8.3 per-epoch eval: {r['eval_forwards']} EMA forwards, "
              f"{k1} K1 launches (168 per forward)")
        out.update(seconds=secs, eval_forwards=r["eval_forwards"],
                   k1_launches=k1, results=lines)

        # K1 against its plain twin on the trained EMA weights, eval batch
        model = build_model(get_config(cfg_name, nc=2), dtype=torch.bfloat16)
        load_reference_state_dict(model, load_inference_params(run / "last"))
        model = model.to(device).to(memory_format=torch.channels_last).eval()
        ds = PairedDetectionDataset.from_sources(rgb_dir, ir_dir,
                                                 img_size=TRAIN_IMG)
        batch = next(iter(BatchLoader(ds, TRAIN_BATCH)))
        xs = [torch.from_numpy(batch[k]).to(device).permute(0, 3, 1, 2)
              .float() / 255.0 for k in ("rgb", "ir")]
        stages = [m for m in model.modules()
                  if isinstance(m, CrossModalFusion)]
        with torch.inference_mode():
            raw_k = model(*xs)
            for m in stages:
                m.stack_fn = cs.fused_cft_stack_plain
            raw_p = model(*xs)
        worst = max(rel_err(a, b)[0] for a, b in zip(raw_k, raw_p))
        print(f"  8.3 trained EMA weights, eval batch: K1 vs plain stack, "
              f"raw head outputs rel {worst:.3e} (tol {TOL_BF16_MODEL:.0e})")
        check(worst <= TOL_BF16_MODEL, f"K1 on trained weights: {worst:.3e}")
        out["k1_vs_plain_rel"] = worst
        del model, raw_k, raw_p

        # the stripped checkpoint through the test CLI, with the val loss
        targs = test_cli.parse_args(["--data", "unused", "--cfg", cfg_name,
                                     "--weights", str(run / "last"),
                                     "--img-size", str(TRAIN_IMG),
                                     "--batch-size", str(TRAIN_BATCH),
                                     "--compute-loss"])
        targs.data = data
        ev = test_cli.run(targs)
        print(f"  8.3 test CLI on {run.name}/last/model.pt: mAP50 "
              f"{ev['map50']:.4f}, val loss [box, obj, cls] "
              f"{ev['val_loss']}")
        check(ev["seen"] == TRAIN_CLI_IMAGES
              and all(math.isfinite(v) for v in ev["val_loss"]),
              "test CLI on the stripped checkpoint")
        out["val_loss"] = ev["val_loss"]

        # detect --update strips the run's training state again (the
        # run's --resume at epoch 2 is phase 11c's, through resume_runs)
        last = run / "last"
        (last / "model.pt").unlink()
        dargs = detect_cli.parse_args([
            "--cfg", cfg_name, "--nc", "2", "--weights", str(last),
            "--source1", rgb_dir, "--source2", ir_dir, "--img-size",
            str(TRAIN_IMG), "--nosave", "--update", "--project",
            str(tmp / "det")])
        d = detect_cli.run(dargs)
        check((last / "model.pt").is_file(), "--update wrote no model.pt")
        print(f"  8.3 detect CLI --update on {run.name}/last: "
              f"{d['n_images']} pairs, model.pt written")
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    finally:
        torch.cuda.empty_cache()
    return out, {"tmp": tmp, "run": run, "data": data}


# phase 9: device-side augmentation, --quad, --evolve, and the parallel path
AUG_BATCH, AUG_MAX_LABELS = 8, 30  # l@640 bs8, labels per tile
HOST_BATCHES = 5  # host batches timed after one, for a median
EVOLVE_IMG, EVOLVE_GENERATIONS = 128, 2
# the device mosaic, card against CPU on the same draws: the resampling
# products accumulate in another order (within 1 level at >= 99.9 % of
# pixels, as tests/test_torch_augment_device.py holds it to JAX's)
TOL_MOSAIC_SHARE, TOL_MOSAIC_TARGETS = 0.999, 1e-4
# a parallel step against one process, on the card. 9c (bf16, world 1):
# bit-equal under deterministic algorithms. 9d (fp32, TF32 off, two ranks
# of 4 images against one of 8): the loss within 8.1's bound, the
# BatchNorm statistics within TOL_DP_STATS and the gradients within
# TOL_DP_L2 relative L2 over all tensors (the batch's sums split over two
# ranks, and cuDNN's algorithms for 4 images and 8)
TOL_DP_STATS, TOL_DP_L2 = 1e-4, 1e-3


def _l_train_state(torch, device, mesh=None, dtype=None):
    """The l model's train state and step as bench_train builds them
    (nc=3, init seed 0), on ``mesh`` when given."""
    from multispectral_object_detection_tpu_torch.models.configs import (
        get_config)
    from multispectral_object_detection_tpu_torch.models.detect import (
        anchor_arrays)
    from multispectral_object_detection_tpu_torch.models.model import (
        build_model, init_weights)
    from multispectral_object_detection_tpu_torch.parallel import mesh as pm
    from multispectral_object_detection_tpu_torch.train.loss import (
        DetectionLoss, LossHyp)
    from multispectral_object_detection_tpu_torch.train.optim import (
        OptHyp, build_optimizer)
    from multispectral_object_detection_tpu_torch.train.trainer import (
        TrainState, make_train_step)

    model = build_model(get_config("yolov5l_fusion_transformerx3", nc=3),
                        dtype=dtype or torch.bfloat16)
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(device).to(memory_format=torch.channels_last)
    if mesh is not None:
        pm.broadcast_module(model)
        pm.parallelize(model, mesh)
    spec = model.spec
    loss_fn = DetectionLoss(3, anchor_arrays(spec.anchors), spec.strides,
                            LossHyp(), mesh=mesh)
    opt = build_optimizer(model, OptHyp(), 100, 300, 8, TRAIN_BATCH)
    state = TrainState(model, opt, mesh)
    seen = []
    update = opt.update
    opt.update = lambda g: (seen.append([t.detach().clone() for t in g]),
                            update(g))[1]
    return state, make_train_step(state, loss_fn), seen


def _step_result(torch, state, step, seen, batch, seed: int) -> dict:
    m = step(*batch, seed=seed)
    return {"loss": {k: float(v) for k, v in m.items()},
            "grads": [g.float().cpu() for g in seen[-1]],
            "stats": {k: v.float().cpu() for k, v in
                      state.model.state_dict().items() if "running_" in k},
            "params": [p.detach().float().cpu()
                       for p in state.model.parameters()]}


def _grad_l2(a, b) -> float:
    """||a - b|| / ||b|| over all gradient tensors."""
    num = sum(float((x - y).double().square().sum()) for x, y in zip(a, b))
    den = sum(float(y.double().square().sum()) for y in b)
    return math.sqrt(num / den)


def _rows(batch, r: int, n: int):
    """Rank r of n's images of a synthetic batch, targets re-indexed."""
    rgb, ir, tg, tm = batch
    b = rgb.shape[0] // n
    k = tg.shape[0] // rgb.shape[0]  # target rows per image
    t = tg[r * b * k:(r + 1) * b * k].copy()
    t[:, 0] -= r * b
    return rgb[r * b:(r + 1) * b], ir[r * b:(r + 1) * b], t, \
        tm[r * b * k:(r + 1) * b * k]


def _gloo_rank_step() -> dict:
    """9d, on each of two gloo ranks sharing cuda:0: which collectives
    gloo runs on CUDA tensors, then one fp32 l@640 step of 4 images per
    rank (dropout on); rank 0 then runs the one-process step on all 8 and
    compares."""
    import torch
    import torch.distributed as dist

    from multispectral_object_detection_tpu_torch.data.synthetic import (
        synthetic_batch)
    from multispectral_object_detection_tpu_torch.parallel import mesh as pm

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    probe = {}
    x = torch.ones(4, device=device)
    for name, fn in (("all_reduce", lambda: dist.all_reduce(x)),
                     ("broadcast", lambda: dist.broadcast(x, 0)),
                     ("all_gather", lambda: dist.all_gather(
                         [torch.empty_like(x) for _ in range(2)], x))):
        try:
            fn()
            torch.cuda.synchronize()
            probe[name] = "ok"
        except Exception as e:  # reported, and the phase fails on it
            probe[name] = f"{type(e).__name__}: {e}"
    check(all(v == "ok" for v in probe.values()),
          f"gloo on CUDA tensors: {probe}")
    mesh = pm.make_mesh(2, 1)
    batch = synthetic_batch(TRAIN_BATCH, TRAIN_IMG, 3, 64, seed=0)
    state, step, seen = _l_train_state(torch, device, mesh, torch.float32)
    part = tuple(torch.from_numpy(a).to(device)
                 for a in _rows(batch, mesh.rank, 2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dp = _step_result(torch, state, step, seen, part, seed=5)
    torch.cuda.synchronize()
    dp_s = time.perf_counter() - t0
    del state, step, seen
    torch.cuda.empty_cache()
    dist.barrier()
    if mesh.rank != 0:
        return None
    ones = []
    for _ in range(2):  # twice: the one-process step's own spread
        state, step, seen = _l_train_state(torch, device, None,
                                           torch.float32)
        ones.append(_step_result(torch, state, step, seen, tuple(
            torch.from_numpy(a).to(device) for a in batch), seed=5))
        del state, step, seen
        torch.cuda.empty_cache()
    one = ones[0]
    loss_rel = abs(dp["loss"]["total"] - one["loss"]["total"]) \
        / abs(one["loss"]["total"])
    stats_rel = max(float((dp["stats"][k] - v).abs().max()
                          / v.abs().max().clamp(min=1e-12))
                    for k, v in one["stats"].items())
    return {"probe": probe, "loss_rel": loss_rel,
            "grad_rel": max(_grad_errors(dp["grads"], one["grads"])),
            "grad_l2": _grad_l2(dp["grads"], one["grads"]),
            "spread_grad_rel": max(_grad_errors(ones[1]["grads"],
                                                one["grads"])),
            "spread_grad_l2": _grad_l2(ones[1]["grads"], one["grads"]),
            "stats_rel": stats_rel, "step_s": dp_s,
            "loss": [dp["loss"]["total"], one["loss"]["total"]]}


def _mosaic_9a(torch, device, card, data) -> dict:
    """9a: the device mosaic at l@640 bs8, card against CPU on the same
    draws, timed beside the host's tile and host-augmented batches."""
    import random

    from multispectral_object_detection_tpu_torch.data.datasets import (
        PairedDetectionDataset, collate_batch, collate_tiles)
    from multispectral_object_detection_tpu_torch.data.hyps import load_hyp
    from multispectral_object_detection_tpu_torch.ops.augment_device import (
        device_mosaic_batch, draw_mosaic)

    hyp = load_hyp("scratch")
    ds = PairedDetectionDataset.from_sources(
        data["train_rgb"], data["train_ir"], img_size=TRAIN_IMG,
        augment=True, hyp=hyp, cache_images=True)
    idx = list(range(AUG_BATCH))
    for i in range(len(ds)):  # decode every pair once (cache_images)
        ds.get_tile(i)

    def host_ms(make):  # a batch each call: the first untimed
        make(0)
        times = []
        for k in range(1, HOST_BATCHES + 1):
            t0 = time.perf_counter()
            make(k)
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    tiles = collate_tiles(ds, idx, random.Random(1), AUG_MAX_LABELS)
    host_tiles = host_ms(lambda k: collate_tiles(
        ds, idx, random.Random(1 + k), AUG_MAX_LABELS))
    host_aug = host_ms(lambda k: collate_batch(
        [ds.get(i, random.Random(AUG_BATCH * k + i)) for i in idx], idx))
    host_tiles_ms = statistics.median(host_tiles)
    host_aug_ms = statistics.median(host_aug)
    draws = draw_mosaic(torch.Generator().manual_seed(2), AUG_BATCH,
                        TRAIN_IMG, hyp)
    args_cpu = [torch.from_numpy(tiles[k]) for k in (
        "tiles_rgb", "tiles_ir", "tile_labels", "tile_lmask")]
    args_gpu = [t.to(device) for t in args_cpu]
    got = device_mosaic_batch(*args_gpu, draws, TRAIN_IMG)
    want = device_mosaic_batch(*args_cpu, draws, TRAIN_IMG)
    share = min(float(((g.cpu().int() - w.int()).abs() <= 1).float().mean())
                for g, w in zip(got[:2], want[:2]))
    t_err = float((got[2].cpu() - want[2]).abs()[want[3] > 0].max())
    masks = bool(torch.equal(got[3].cpu(), want[3]))
    mos_ms = cuda_ms(lambda: device_mosaic_batch(*args_gpu, draws,
                                                 TRAIN_IMG), iters=10)
    up_ms = cuda_ms(lambda: [torch.from_numpy(tiles[k]).to(device)
                             for k in ("tiles_rgb", "tiles_ir")], iters=5)
    print(f"  9a device mosaic l@{TRAIN_IMG} bs{AUG_BATCH}: card vs CPU "
          f"pixels within 1 level {share:.6f}, targets {t_err:.2e}, masks "
          f"equal {masks}; {mos_ms:.3f} ms per batch on the card (+ "
          f"{up_ms:.3f} ms tile upload); host, decodes cached, median of "
          f"{HOST_BATCHES} batches: collate_tiles {host_tiles_ms:.1f} ms "
          f"({min(host_tiles):.1f}-{max(host_tiles):.1f}), host-augmented "
          f"collate_batch {host_aug_ms:.1f} ms ({min(host_aug):.1f}-"
          f"{max(host_aug):.1f}) per batch [{card}]")
    check(share >= TOL_MOSAIC_SHARE and t_err <= TOL_MOSAIC_TARGETS
          and masks, "device mosaic: card and CPU disagree")
    return {"ms": mos_ms, "upload_ms": up_ms, "host_tiles_ms": host_tiles,
            "host_augmented_ms": host_aug, "within_1_level": share,
            "targets_err": t_err}


def _train_cli_9b(torch, card, data, project) -> dict:
    """9b: the train CLI with --device-aug (2 epochs) and --quad (1) at
    l@640 bs8, and --evolve 2 on the n model; K1's launches per EMA eval
    forward."""
    from multispectral_object_detection_tpu_torch.cli import train_cli

    def train(argv):
        args = train_cli.parse_args(
            ["--data", "unused", "--cfg", "yolov5l_fusion_transformerx3",
             "--img-size", str(TRAIN_IMG), "--batch-size", str(TRAIN_BATCH),
             "--project", str(project)] + argv)
        args.data = data
        l0 = kernel_launches()
        t0 = time.perf_counter()
        r = (train_cli.evolve if args.evolve else train_cli.run)(args)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0, k1_launches(l0)

    cli = {}
    for name, argv in (("device_aug", ["--epochs", "2", "--device-aug",
                                       "--nosave"]),
                       ("quad", ["--epochs", "1", "--quad", "--nosave"])):
        r, secs, k1 = train(argv + ["--name", name])
        lines = (Path(r["save_dir"]) / "results.txt").read_text() \
            .splitlines()
        epochs = [float(ln.split("(")[1].split("s)")[0]) for ln in lines]
        print(f"  9b train CLI {' '.join(argv)}: {secs:.1f} s, epochs "
              f"{epochs} s, {r['eval_forwards']} EMA eval forwards, {k1} K1 "
              f"launches [{card}]")
        for ln in lines:
            print(f"      {ln}")
        check(len(lines) == int(argv[1])
              and all("mAP50" in ln for ln in lines),
              f"{name}: results.txt lacks an epoch's eval")
        check(k1 == 168 * r["eval_forwards"] > 0,
              f"{name}: K1 launches {k1} != 168 x {r['eval_forwards']}")
        cli[name] = {"seconds": secs, "epoch_s": epochs, "k1": k1,
                     "eval_forwards": r["eval_forwards"]}
    r, secs, k1 = train(["--cfg", "yolov5n_fusion_transformerx3",
                         "--img-size", str(EVOLVE_IMG), "--epochs", "1",
                         "--evolve", str(EVOLVE_GENERATIONS), "--name", "evo"])
    rows = (Path(project) / "evo_evolve" / "evolve.txt").read_text() \
        .splitlines()
    print(f"  9b train CLI --evolve {EVOLVE_GENERATIONS} (n model at "
          f"{EVOLVE_IMG}): {secs:.1f} s, {len(rows)} evolve.txt rows, {k1} K1 "
          f"launches")
    check(len(rows) == EVOLVE_GENERATIONS and k1 > 0 and k1 % 168 == 0,
          "--evolve: rows or K1 launches")
    cli["evolve"] = {"seconds": secs, "rows": len(rows), "k1": k1}
    return cli


def _resample_matrix(torch, n_in: int, n_out: int, mode: str, device):
    """(n_out, n_in) fp32 matrix of PyTorch's 1-D adaptive average pool
    ("pool") or bilinear resize with align_corners=False ("linear")."""
    m = torch.zeros(n_out, n_in, dtype=torch.float64)
    for i in range(n_out):
        if mode == "pool":
            a, b = (i * n_in) // n_out, -(-(i + 1) * n_in // n_out)
            m[i, a:b] = 1.0 / (b - a)
        else:
            src = max((i + 0.5) * n_in / n_out - 0.5, 0.0)
            i0 = min(int(src), n_in - 1)
            m[i, i0] += 1.0 - (src - i0)
            m[i, min(i0 + 1, n_in - 1)] += src - i0
    return m.float().to(device)


def _by_matrices(torch, mode: str):
    """A (B, C, H, W) -> (B, C, *out_hw) pool or resize as two matrix
    products, whose backward needs no atomic adds."""
    def resample(x, out_hw):
        mh = _resample_matrix(torch, x.shape[2], out_hw[0], mode, x.device)
        mw = _resample_matrix(torch, x.shape[3], out_hw[1], mode, x.device)
        return torch.einsum("hH,bcHW,wW->bchw", mh, x.float(), mw) \
            .to(x.dtype)
    return resample


@contextlib.contextmanager
def _deterministic(torch):
    """Within: PyTorch's deterministic algorithms (cuDNN's, cuBLAS's fixed
    workspace), and the CFT stages' adaptive pool and bilinear resize as
    matrix products, because PyTorch's CUDA backward of both adds
    atomically and has no deterministic version; restored on exit."""
    from multispectral_object_detection_tpu_torch.models import fusion

    cudnn = torch.backends.cudnn
    saved = (torch.are_deterministic_algorithms_enabled(),
             cudnn.deterministic, cudnn.benchmark,
             os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
             fusion.adaptive_avg_pool_2d, fusion.bilinear_resize_2d)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    cudnn.deterministic, cudnn.benchmark = True, False
    fusion.adaptive_avg_pool_2d = _by_matrices(torch, "pool")
    fusion.bilinear_resize_2d = _by_matrices(torch, "linear")
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0])
        cudnn.deterministic, cudnn.benchmark = saved[1:3]
        if saved[3] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved[3]
        fusion.adaptive_avg_pool_2d, fusion.bilinear_resize_2d = saved[4:]


def _differences(torch, a, b) -> list:
    """The names of a step's results that are not bit-equal."""
    out = [f"loss {k}" for k in a["loss"] if a["loss"][k] != b["loss"][k]]
    out += [k for k in a["stats"] if not torch.equal(a["stats"][k],
                                                      b["stats"][k])]
    for what in ("grads", "params"):
        out += [f"{what} {i}" for i, (x, y) in enumerate(zip(a[what],
                                                              b[what]))
                if not torch.equal(x, y)]
    return out


def _world1_9c(torch, device, card, data, store) -> dict:
    """9c: the data-parallel step and eval at world 1 over NCCL against
    one process: the step bit-equal under deterministic algorithms (and
    the one-process step equal to its own repeat there), the eval
    metrics equal."""
    import torch.distributed as dist

    from multispectral_object_detection_tpu_torch.data.datasets import (
        BatchLoader, PairedDetectionDataset)
    from multispectral_object_detection_tpu_torch.data.synthetic import (
        synthetic_batch)
    from multispectral_object_detection_tpu_torch.parallel import mesh as pm
    from multispectral_object_detection_tpu_torch.train.evaluator import (
        evaluate)
    from multispectral_object_detection_tpu_torch.train.trainer import (
        make_eval_forward)

    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    try:
        mesh = pm.make_mesh(1, 1)
        batch = tuple(torch.from_numpy(a).to(device) for a in synthetic_batch(
            TRAIN_BATCH, TRAIN_IMG, 3, 64, seed=0))
        runs = {}
        for tag, m in (("one", None), ("one_again", None), ("dp", mesh)):
            state, step, seen = _l_train_state(torch, device, m)
            with _deterministic(torch):
                runs[tag] = _step_result(torch, state, step, seen, batch, 4)
            if tag == "dp":
                loader = BatchLoader(PairedDetectionDataset.from_sources(
                    data["val_rgb"], data["val_ir"], img_size=TRAIN_IMG),
                    TRAIN_BATCH)
                fwd = make_eval_forward(state)
                ev = [evaluate(fwd, loader, 3, device=device, shard=s)
                      for s in (None, pm.EvalShard(mesh, TRAIN_BATCH))]
            del state, step, seen
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    one = runs["one"]
    repeat = _differences(torch, runs["one_again"], one)
    dp = _differences(torch, runs["dp"], one)
    n = len(one["loss"]) + len(one["stats"]) + len(one["grads"]) \
        + len(one["params"])
    keys = ("mp", "mr", "map50", "map", "seen", "nms_candidates")
    ev_equal = all(ev[0][k] == ev[1][k] for k in keys)
    print(f"  9c world 1 over NCCL, l@{TRAIN_IMG} bs{TRAIN_BATCH} bf16, "
          f"deterministic algorithms: of {n} results (losses, BatchNorm "
          f"statistics, gradients, updated weights) the data-parallel step "
          f"differs from one process's in {len(dp)} {dp[:4]}, one process "
          f"from its repeat in {len(repeat)} {repeat[:4]}; eval metrics "
          f"equal {ev_equal} (mAP50 {ev[1]['map50']:.5f}) [{card}]")
    check(not repeat, "the one-process step is not deterministic: " +
          ", ".join(repeat[:8]))
    check(not dp, "the world-1 data-parallel step is not bit-equal to one "
          "process's: " + ", ".join(dp[:8]))
    check(ev_equal, "the world-1 data-parallel eval differs")
    return {"results": n, "differ": len(dp), "repeat_differs": len(repeat),
            "eval_equal": ev_equal}


def _gloo_9d(card, store_dir) -> dict:
    """9d: two gloo ranks sharing the card against one process."""
    from multispectral_object_detection_tpu_torch.parallel import mesh as pm

    t0 = time.perf_counter()
    r = pm.spawn(2, _gloo_rank_step, backend="gloo", timeout=600,
                 store_dir=str(store_dir), threads=4)
    secs = time.perf_counter() - t0
    print(f"  9d two gloo ranks on cuda:0, l@{TRAIN_IMG} fp32, 4 images per "
          f"rank: gloo on CUDA tensors {r['probe']}; loss {r['loss'][0]:.6f} "
          f"vs one process {r['loss'][1]:.6f} (rel {r['loss_rel']:.3g}), "
          f"gradients worst tensor rel {r['grad_rel']:.3g}, all rel L2 "
          f"{r['grad_l2']:.3g} (one process twice: {r['spread_grad_rel']:.3g}"
          f", {r['spread_grad_l2']:.3g}), BatchNorm statistics rel "
          f"{r['stats_rel']:.3g}; the ranks' step {r['step_s']:.2f} s "
          f"(first, with its collectives); {secs:.1f} s in all [{card}]")
    check(r["loss_rel"] <= TOL_TRAIN_LOSS and r["stats_rel"] <= TOL_DP_STATS
          and r["grad_l2"] <= TOL_DP_L2,
          "two gloo ranks disagree with one process")
    r["seconds"] = secs
    return r


def phase_parallel_aug(torch, device, card: str) -> dict:
    """Phase 9: (a) the device mosaic; (b) the train CLI with --device-aug,
    --quad and --evolve; (c) the data-parallel step and eval at world 1
    over NCCL; (d) two gloo ranks on the card."""
    from multispectral_object_detection_tpu_torch.data.synthetic import (
        make_paired_dataset)

    t_phase = time.perf_counter()
    out = {"card": card}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_par_"))
    try:
        rgb_dir, ir_dir = make_paired_dataset(str(tmp / "data"),
                                              n_images=TRAIN_CLI_IMAGES,
                                              img_size=TRAIN_IMG, nc=2,
                                              seed=7)
        data = {"train_rgb": rgb_dir, "train_ir": ir_dir, "val_rgb": rgb_dir,
                "val_ir": ir_dir, "nc": 2, "names": ["red", "blue"]}
        out["mosaic"] = _mosaic_9a(torch, device, card, data)
        torch.cuda.empty_cache()
        out["cli"] = _train_cli_9b(torch, card, data, tmp / "runs")
        out["world1"] = _world1_9c(torch, device, card, data, tmp / "store")
        torch.cuda.empty_cache()
        out["gloo_2_ranks"] = _gloo_9d(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out

# ------------------------------------------------------------- phase 10
# the 13 hub configs of tests/test_model.py with their parameter pins
# (verified there against the reference under torch); the P6 family runs
# at 1280 px, the rest at 640
ZOO = (("yolov3", 61949149), ("yolov3-spp", 62998749),
       ("yolov3-tiny", 8852366), ("yolov5-fpn", 50262781),
       ("yolov5-panet", 47818749), ("yolov5-p2", 47953533),
       ("yolov5-p7", 143955579), ("yolov5s6", 12667836),
       ("yolov5m6", 35917020), ("yolov5l6", 77263228),
       ("yolov5x6", 141821340), ("yolov5-p6", 77263228),
       ("yolov5s-transformer", 7276861))
ZOO_P6 = {"yolov5s6", "yolov5m6", "yolov5l6", "yolov5x6", "yolov5-p6"}
ZOO_IMG, ZOO_P6_IMG, ZOO_BATCH = 640, 1280, 2
# Grad-CAM nodes of l@640 transformerx3: the RGB stem at P3, the P4 CFT
# stage's output added to the RGB stream (the stage itself outputs a pair)
# and the last neck node (P5)
CAM_LAYERS = (4, 18, 45)
CAM_GRAD_IMG = 320     # one pair, so the CPU's fp32 backward stays short
TOL_CAM_GRAD = 1e-3    # fp32 card vs CPU, TF32 off, CAM in [0, 1]
EXPORT_CONF = 0.01     # random weights score about 0.02: boxes to compare


def _zoo_10a(torch, device) -> dict:
    """10a: every hub config built at full width on the card with its pin,
    a fused bf16 forward against the unfused fp32 model, ms per batch; the
    P6 constructor serving 2 frames; yolov5l6 with --c3-kernel, K2 at its
    new shapes against the plain twin."""
    from multispectral_object_detection_tpu_torch import hubconf
    from multispectral_object_detection_tpu_torch.hub import create
    from multispectral_object_detection_tpu_torch.models.configs import (
        get_config)
    from multispectral_object_detection_tpu_torch.models.layers import (
        Bottleneck)
    from multispectral_object_detection_tpu_torch.models.model import (
        build_model, cast_inference_params, init_weights,
        load_reference_state_dict)
    from multispectral_object_detection_tpu_torch.ops import c3_bottleneck as k2

    import numpy as np

    out = {"configs": {}}
    gen = torch.Generator(device=device).manual_seed(10)
    for name, pin in ZOO:
        img = ZOO_P6_IMG if name in ZOO_P6 else ZOO_IMG
        cfg = get_config(name)
        ref = build_model(cfg)
        init_weights(ref, torch.Generator().manual_seed(0))
        n_par = sum(p.numel() for p in ref.parameters())
        check(n_par == pin, f"{name}: {n_par} parameters, pinned {pin}")
        sd = ref.state_dict()
        ref = ref.to(device).to(memory_format=torch.channels_last)
        fused = create(cfg, state_dict=sd, dtype=torch.bfloat16,
                       device=device)
        x = torch.rand((ZOO_BATCH, 3, img, img), generator=gen,
                       device=device).contiguous(
                           memory_format=torch.channels_last)
        with torch.inference_mode():
            want = ref(x)
            got = fused(x)
            ms = cuda_ms(lambda: fused(x), iters=5, warmup=1)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(g.float()).all()) for g in got),
              f"{name}: non-finite outputs")
        worst = max(rel_err(g, w)[0] for g, w in zip(got, want))
        print(f"zoo {name}: {n_par:,} parameters (pinned), {len(got)} scales "
              f"at {img} px, fused bf16 vs fp32 rel={worst:.3e} "
              f"tol={TOL_BF16_MODEL:.1e}, {ms:.3f} ms per batch of "
              f"{ZOO_BATCH}")
        check(worst <= TOL_BF16_MODEL, f"{name}: bf16 forward disagrees")
        out["configs"][name] = {"params": n_par, "img": img,
                                "rel_err": worst, "ms": ms}
        del ref, fused, x, want, got
        torch.cuda.empty_cache()

    # the P6 constructor, through Detector.__call__ (single stream)
    det = hubconf.yolov5l6(img_size=ZOO_P6_IMG, conf=SERVE_CONF,
                           device=device,
                           generator=torch.Generator().manual_seed(0))
    rng = torch.Generator().manual_seed(11)
    frames = [torch.randint(0, 256, (1024, 1280, 3), dtype=torch.uint8,
                            generator=rng).numpy() for _ in range(2)]
    res = det(frames)
    check(len(res) == 2 and all(np.isfinite(b).all() and
                                (b[:, 2] <= 1280).all() for b in res.boxes),
          "hubconf.yolov5l6: results")
    print(f"zoo hubconf.yolov5l6: Detector.__call__ on 2 frames of "
          f"1280x1024, detections {[len(b) for b in res.boxes]}")
    out["hubconf_yolov5l6_detections"] = [len(b) for b in res.boxes]
    del det

    # yolov5l6 with --c3-kernel at 1280: K2 at the P6 family's shapes
    model = build_model(get_config("yolov5l6"), dtype=torch.bfloat16,
                        use_c3_kernel=True)
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(device).fuse()
    cast_inference_params(model, torch.bfloat16)
    model = model.to(memory_format=torch.channels_last)
    blocks = [m for m in model.modules()
              if isinstance(m, Bottleneck) and m.takes_kernel]
    seen = {}  # NHWC shape -> [a block, its input, blocks of that shape]

    def grab(mod, inp, _out):
        x = inp[0].permute(0, 2, 3, 1)
        if tuple(x.shape) not in seen:
            seen[tuple(x.shape)] = [mod, x.contiguous(), 0]
        seen[tuple(x.shape)][2] += 1

    x = torch.rand((ZOO_BATCH, 3, ZOO_P6_IMG, ZOO_P6_IMG), generator=gen,
                   device=device).contiguous(memory_format=torch.channels_last)
    hooks = [m.register_forward_hook(grab) for m in blocks]
    l0 = kernel_launches()
    with torch.inference_mode():
        raw_k = model(x)
    torch.cuda.synchronize()
    launches = kernel_launches(l0)["c3_bottleneck"]
    for h in hooks:
        h.remove()
    check(launches == 2 * len(blocks) and len(blocks) == 24,
          f"yolov5l6 --c3-kernel: {launches} K2 launches for "
          f"{len(blocks)} blocks, expected 48 for 24")
    shapes, k2_ms = {}, 0.0
    for shape, (m, xin, n) in sorted(seen.items()):
        w1, w2 = m.kernel_weights(xin.dtype)
        args = (xin, w1, m.cv1.conv.bias, w2, m.cv2.conv.bias)
        with torch.inference_mode():
            rel = rel_err(k2.c3_bottleneck(*args),
                          k2.c3_bottleneck_plain(*args))[0]
            ms = cuda_ms(lambda: k2.c3_bottleneck(*args), iters=10)
        check(rel <= TOL_BF16, f"K2 at {shape}: rel={rel:.3e}")
        shapes[str(shape)] = {"blocks": n, "rel_err": rel, "ms": ms}
        k2_ms += n * ms
        print(f"zoo yolov5l6 K2 at {shape} x {n}: rel={rel:.3e} "
              f"tol={TOL_BF16:.1e}, {ms:.4f} ms per block")
    for m in blocks:
        m.c3_fn = k2.c3_bottleneck_plain
    with torch.inference_mode():
        raw_p = model(x)
        fwd_ms = cuda_ms(lambda: model(x), iters=5, warmup=1)
        for m in blocks:
            m.c3_fn = k2.c3_bottleneck
        fwd_k_ms = cuda_ms(lambda: model(x), iters=5, warmup=1)
    worst = max(rel_err(a, b)[0] for a, b in zip(raw_k, raw_p))
    check(worst <= TOL_BF16_MODEL, f"yolov5l6 K2 forward: rel={worst:.3e}")
    print(f"zoo yolov5l6 --c3-kernel at {ZOO_P6_IMG} px bs{ZOO_BATCH}: K2 "
          f"{launches} launches per forward, {k2_ms:.4f} ms of K2; forward "
          f"{fwd_k_ms:.3f} ms (plain twin {fwd_ms:.3f}); raw outputs K2 vs "
          f"plain rel={worst:.3e}")
    # PERF's kernel-table row: one forward's blocks, each on inputs of its
    # own, timed as phase 7 times the l@640 row (graph replay), beside the
    # plain twin, the cuDNN route and the bound
    bf, g2 = torch.bfloat16, torch.Generator().manual_seed(12)
    row = dict.fromkeys(("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms",
                         "bound_ms"), 0.0)
    for shape, (_, _, n) in sorted(seen.items()):
        ins = [k2_inputs(shape, bf, bf, g2, device) for _ in range(n)]
        libs = [k2_library(*b) for b in ins]
        row["ms"] += graph_ms(lambda: [k2.c3_bottleneck(*b) for b in ins])
        row["plain_ms"] += graph_ms(
            lambda: [k2.c3_bottleneck_plain(*b) for b in ins])
        row["library_ms"] += graph_ms(lambda: [f() for f in libs])
        P, C = shape[0] * shape[1] * shape[2], shape[3]
        tb = n * 2 * (2 * P * C + 10 * C * C + 2 * C) / PEAK_BYTES_PER_S * 1e3
        to = n * 20 * P * C * C / PEAK_FLOPS["bf16"] * 1e3
        row["bytes_ms"] += tb
        row["ops_ms"] += to
        row["bound_ms"] += max(tb, to)
        del ins, libs
    row["bound_by"] = "bytes" if row["bytes_ms"] >= row["ops_ms"] \
        else "operations"
    print(f"zoo yolov5l6 K2 row ({launches} launches, graph replay): "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, cuDNN route "
          f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f} "
          f"({row['bound_by']}), {row['bound_ms'] / row['ms']:.1%} of it")
    out["yolov5l6_c3_kernel"] = {"k2_launches": launches, "k2_ms": k2_ms,
                                 "forward_ms": fwd_k_ms,
                                 "forward_plain_ms": fwd_ms,
                                 "rel_err": worst, "shapes": shapes,
                                 "row": row}
    del model, raw_k, raw_p, x, seen
    torch.cuda.empty_cache()
    return out


def _gradcam_10b(torch, device, tmp: Path) -> dict:
    """10b: Grad-CAM on l@640 transformerx3: sum mode through K1 against
    the plain stack, grad mode in fp32 card vs CPU on one pair at 320 px,
    and the CLI's overlays. Returns the result and the .pt written."""
    from multispectral_object_detection_tpu_torch.data.synthetic import (
        make_paired_dataset)
    from multispectral_object_detection_tpu_torch.hub import create
    from multispectral_object_detection_tpu_torch.models.model import (
        plain_kernels)
    from multispectral_object_detection_tpu_torch.utils import gradcam

    name = "yolov5l_fusion_transformerx3"
    out = {"layers": list(CAM_LAYERS)}
    model = create(name, 1, dtype=torch.bfloat16, device=device,
                   generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device=device).manual_seed(12)
    x, x2 = (torch.rand((2, 3, IMG, IMG), generator=gen, device=device)
             for _ in range(2))
    for layer in CAM_LAYERS:
        l0 = kernel_launches()
        cam_k = gradcam.compute_cam(model, x, x2, layer=layer, mode="sum")
        torch.cuda.synchronize()
        k1 = k1_launches(l0)
        acts = []
        for plain in (False, True):
            with contextlib.ExitStack() as stack:
                if plain:
                    stack.enter_context(plain_kernels(model))
                box = stack.enter_context(gradcam.tap(model, layer))
                with torch.inference_mode():
                    model(x, x2)
                acts.append(box["act"])
        with plain_kernels(model):
            cam_p = gradcam.compute_cam(model, x, x2, layer=layer,
                                        mode="sum")
        rel = rel_err(*acts)[0]
        d = (cam_k - cam_p).abs().max().item()
        print(f"gradcam sum node {layer}: CAM {tuple(cam_k.shape)}, K1 "
              f"{k1} launches; the node's activation K1 vs plain rel="
              f"{rel:.3e} tol={TOL_BF16_MODEL:.1e}, CAMs max|diff|={d:.3e}")
        check(k1 == 168 and rel <= TOL_BF16_MODEL,
              f"gradcam sum node {layer}: K1 launches {k1}, rel {rel:.3e}")
        out[f"sum_{layer}"] = {"k1_launches": k1, "act_rel_err": rel,
                               "cam_max_abs_diff": d}
    sd = {k: v.float() for k, v in create(
        name, 1, dtype=torch.float32, device=device, fuse=False,
        generator=torch.Generator().manual_seed(0)).state_dict().items()}
    del model
    torch.cuda.empty_cache()

    # grad mode: fp32 on the card against the CPU, TF32 off
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cpu_sd = {k: v.cpu() for k, v in sd.items()}
        m_gpu = create(name, 1, state_dict=sd, dtype=torch.float32,
                       device=device)
        m_cpu = create(name, 1, state_dict=cpu_sd, dtype=torch.float32,
                       device="cpu")
        g = torch.Generator().manual_seed(13)
        a, b = (torch.rand((1, 3, CAM_GRAD_IMG, CAM_GRAD_IMG), generator=g)
                for _ in range(2))
        for layer in CAM_LAYERS:
            t0 = time.perf_counter()
            cam_g = gradcam.compute_cam(m_gpu, a.to(device), b.to(device),
                                        layer=layer, mode="grad")
            cam_c = gradcam.compute_cam(m_cpu, a, b, layer=layer,
                                        mode="grad")
            d = (cam_g.cpu() - cam_c).abs().max().item()
            print(f"gradcam grad node {layer}: fp32 card vs CPU max|diff|="
                  f"{d:.3e} tol={TOL_CAM_GRAD:.1e} "
                  f"({time.perf_counter() - t0:.1f} s)")
            check(d <= TOL_CAM_GRAD, f"gradcam grad node {layer}: {d:.3e}")
            out[f"grad_{layer}"] = {"max_abs_diff": d}
        del m_gpu, m_cpu
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32

    # the CLI, on a bf16 .pt of the same weights
    ckpt = tmp / "l.pt"
    torch.save({k: v.to(torch.bfloat16) if v.is_floating_point() else v
                for k, v in sd.items()}, ckpt)
    del sd, cpu_sd
    rgb_dir, ir_dir = make_paired_dataset(str(tmp / "cam"), n_images=2,
                                          img_size=IMG, nc=1, seed=9)
    rc = gradcam.main(["--cfg", name, "--nc", "1", "--weights", str(ckpt),
                       "--source1", rgb_dir, "--source2", ir_dir,
                       "--layers", *map(str, CAM_LAYERS[:2]), "--img-size",
                       str(IMG), "--mode", "sum", "--project",
                       str(tmp / "cam_runs")])
    files = sorted((tmp / "cam_runs" / "exp").iterdir())
    check(rc == 0 and len(files) == 4, f"gradcam CLI: rc {rc}, {files}")
    print(f"gradcam CLI: {len(files)} overlays ({files[0].suffix})")
    out["cli_overlays"] = len(files)
    torch.cuda.empty_cache()
    return out, ckpt


def _export_10c(torch, device, ckpt: Path, tmp: Path) -> dict:
    """10c: the export CLI on l@640 batch 1 with and without --with-nms;
    torch.export.load runs each on the card against Detector.infer (K1)."""
    from multispectral_object_detection_tpu_torch.cli import export_cli
    from multispectral_object_detection_tpu_torch.hub import Detector
    from multispectral_object_detection_tpu_torch.ops.boxes import (
        pairwise_iou)
    from multispectral_object_detection_tpu_torch.ops.nms import batched_nms

    name = "yolov5l_fusion_transformerx3"
    export_cli.NMS_KW["conf_thres"] = EXPORT_CONF
    det = Detector(name, nc=1, weights=str(ckpt), img_size=IMG,
                   conf=EXPORT_CONF, device=device)
    gen = torch.Generator(device=device).manual_seed(14)
    rgb, ir = (torch.randint(0, 256, (1, IMG, IMG, 3), dtype=torch.uint8,
                             generator=gen, device=device) for _ in range(2))
    with torch.inference_mode():
        want_dets = det.model.decode(det.raw(rgb, ir))
        want = det.infer(rgb, ir)
    infer_ms = cuda_ms(lambda: det.infer(rgb, ir), iters=5, warmup=1)
    out = {"infer_ms": infer_ms}
    progs = {}
    for nms in (False, True):
        t0 = time.perf_counter()
        d = export_cli.run(export_cli.parse_args(
            ["--cfg", name, "--weights", str(ckpt), "--img-size", str(IMG),
             "--out", str(tmp / f"export_{nms}")]
            + (["--with-nms"] if nms else [])))
        t_export = time.perf_counter() - t0
        manifest = json.loads((Path(d) / "manifest.json").read_text())
        program = torch.export.load(str(Path(d) / "model.pt2")).module()
        t_load = time.perf_counter() - t0 - t_export
        l0 = kernel_launches()
        got = program(rgb, ir)
        torch.cuda.synchronize()
        check(k1_launches(l0) == 0,
              "the exported program launched a ctypes kernel")
        ms = cuda_ms(lambda: program(rgb, ir), iters=5, warmup=1)
        progs[nms] = got
        check(manifest["platforms"] == ["cuda"] and
              manifest["with_nms"] == nms, f"manifest {manifest}")
        if not nms:
            rel = rel_err(got, want_dets)[0]
            print(f"export (no NMS): decoded {tuple(got.shape)} vs "
                  f"Detector's (K1) rel={rel:.3e} tol={TOL_BF16_MODEL:.1e}")
            check(rel <= TOL_BF16_MODEL, f"exported decode: {rel:.3e}")
            out["no_nms"] = {"export_s": t_export, "load_s": t_load,
                             "ms": ms, "rel_err": rel}
        else:
            boxes, scores, classes, valid = got
            # the traced fixed-trip NMS against the early-exit form on the
            # program's own decoded detections
            ref = batched_nms(progs[False], conf_thres=EXPORT_CONF,
                              iou_thres=0.45, multi_label=False,
                              max_det=300, top_k=1024)
            same = bool(torch.equal(valid, ref.valid) and
                        torch.equal(classes, ref.classes) and
                        torch.allclose(boxes, ref.boxes, atol=1e-3))
            # against Detector.infer (K1): bf16 rounding reorders the
            # near-equal scores of random weights, so greedy NMS keeps
            # other boxes of a cluster; each box kept by one side must lie
            # in a cluster the other keeps (same class, IoU > 0.45, the
            # suppression threshold)
            def covered(a, b):
                va, vb = a.valid[0], b.valid[0]
                iou = pairwise_iou(a.boxes[0][va], b.boxes[0][vb])
                hit = (iou > 0.45) & (a.classes[0][va][:, None] ==
                                      b.classes[0][vb][None, :])
                return float(hit.any(1).float().mean()) if int(va.sum()) \
                    else 1.0

            mine = ref._replace(boxes=boxes, scores=scores, classes=classes,
                                valid=valid)
            v, wv = valid[0], want.valid[0]
            share = min(covered(mine, want), covered(want, mine))
            print(f"export (NMS): {int(v.sum())} boxes (Detector.infer "
                  f"{int(wv.sum())}); equal to batched_nms on its decode: "
                  f"{same}; each side's boxes in the other's clusters: "
                  f"{share:.3f}")
            check(same and share >= 0.9 and int(v.sum()) > 0,
                  "exported NMS program disagrees")
            out["nms"] = {"export_s": t_export, "load_s": t_load, "ms": ms,
                          "boxes": int(v.sum()),
                          "infer_boxes": int(wv.sum()),
                          "covered": share}
        print(f"export{' --with-nms' if nms else ''}: export "
              f"{t_export:.1f} s, load {t_load:.1f} s, {ms:.3f} ms per "
              f"batch of 1 (Detector.infer {infer_ms:.3f} ms)")
    export_cli.NMS_KW["conf_thres"] = 0.25
    del det, progs
    torch.cuda.empty_cache()
    return out


def _profiling_10d(torch, device) -> dict:
    """10d: model_info of l@640: parameters and GFLOPs with every CFT
    layer, beside K1's analytic FLOPs."""
    from multispectral_object_detection_tpu_torch.hub import create
    from multispectral_object_detection_tpu_torch.ops import cft_stack as cs
    from multispectral_object_detection_tpu_torch.utils import profiling

    model = create("yolov5l_fusion_transformerx3", 1, dtype=torch.bfloat16,
                   device=device, fuse=False,
                   generator=torch.Generator().manual_seed(0))
    info = profiling.model_info(model, IMG)
    k1 = profiling.cft_flops(model)
    plain = cs.fused_cft_stack_plain
    cs.fused_cft_stack_plain = lambda x, *w, **k: x
    try:
        without = profiling.estimate_flops(model, IMG)
    finally:
        cs.fused_cft_stack_plain = plain
    print(f"profiling l@640: {info['layers']} nodes, {info['params']:,} "
          f"parameters, {info['flops'] / 1e9:.3f} GFLOPs per pair; the 24 "
          f"CFT layers {(info['flops'] - without) / 1e9:.3f} GFLOPs, K1's "
          f"analytic count {k1 / 1e9:.3f} (x16 = {16 * k1 / 1e9:.3f} per "
          f"bs16 forward)")
    check(info["params"] == 206247222 and info["flops"] - without == k1,
          "model_info: parameters or CFT FLOPs")
    del model
    torch.cuda.empty_cache()
    return {"params": info["params"], "gflops": info["flops"] / 1e9,
            "cft_gflops": k1 / 1e9}


def _plots_10e(torch, ckpt: Path, tmp: Path) -> dict:
    """10e: test_cli --plots (the missing-matplotlib exit, or the plots);
    the train CLI for one epoch with --wandb and no wandb."""
    import logging

    from multispectral_object_detection_tpu_torch.cli import (test_cli,
                                                               train_cli)
    from multispectral_object_detection_tpu_torch.data.synthetic import (
        make_paired_dataset)
    from multispectral_object_detection_tpu_torch.utils import plots

    rgb_dir, ir_dir = make_paired_dataset(str(tmp / "plots"), n_images=4,
                                          img_size=IMG, nc=1, seed=15)
    data = {"train_rgb": rgb_dir, "train_ir": ir_dir, "val_rgb": rgb_dir,
            "val_ir": ir_dir, "nc": 1, "names": ["person"]}
    args = test_cli.parse_args(["--data", "unused", "--weights", str(ckpt),
                                "--plots", "--save-hybrid", "--project",
                                str(tmp / "test_runs"), "--batch-size", "4"])
    args.data = data
    out = {"matplotlib": plots.available()}
    if plots.available():
        test_cli.run(args)
        written = sorted(p.name for p in (tmp / "test_runs" / "exp").glob(
            "*.png"))
        check("confusion_matrix.png" in written, f"plots: {written}")
        print(f"test_cli --plots: {written}")
    else:
        try:
            test_cli.run(args)
            raise RuntimeError("test_cli --plots ran without matplotlib")
        except SystemExit as e:
            check("matplotlib" in str(e), f"test_cli --plots: {e}")
            print(f"test_cli --plots without matplotlib: {e}")
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logging.getLogger().addHandler(handler)
    saved = sys.modules.get("wandb", "absent")
    sys.modules["wandb"] = None  # no wandb, whether installed or not
    targs = train_cli.parse_args([
        "--data", "unused", "--cfg", "yolov5n_fusion_transformerx3",
        "--img-size", "128", "--batch-size", "4", "--epochs", "1", "--wandb",
        "--noval", "--noautoanchor", "--project", str(tmp / "train_runs")])
    targs.data = data
    try:
        t0 = time.perf_counter()
        r = train_cli.run(targs)
    finally:
        logging.getLogger().removeHandler(handler)
        if saved == "absent":
            del sys.modules["wandb"]
        else:
            sys.modules["wandb"] = saved
    warned = [m for m in records if "wandb unavailable" in m]
    lines = (Path(r["save_dir"]) / "results.txt").read_text().splitlines()
    check(len(warned) == 1 and len(lines) == 1,
          f"train CLI --wandb: warnings {warned}, results {lines}")
    print(f"train_cli --wandb without wandb: warned once, 1 epoch in "
          f"{time.perf_counter() - t0:.1f} s: {lines[0]}")
    out["train_wandb_warned"] = True
    return out


def phase_long_tail(torch, device) -> dict:
    """Phase 10: the hub zoo, Grad-CAM, export, profiling, plots and
    loggers on the card."""
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tail_"))
    out = {}
    try:
        t0 = time.perf_counter()
        out["zoo"] = _zoo_10a(torch, device)
        out["zoo"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["gradcam"], ckpt = _gradcam_10b(torch, device, tmp)
        out["gradcam"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["export"] = _export_10c(torch, device, ckpt, tmp)
        out["export"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["profiling"] = _profiling_10d(torch, device)
        t1 = time.perf_counter()
        out["plots_loggers"] = _plots_10e(torch, ckpt, tmp)
        out["plots_loggers"]["seconds"] = time.perf_counter() - t1
        out["profiling"]["seconds"] = t1 - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ------------------------------------------------------------- phase 11
PROFILE_ITERS = 2
# the FLOPs of one l@640 pair: model_info's count (phase 10d, nc=1); the MFU
# tool counts with nc=3, as the JAX tool does (0.034 GFLOPs more in the
# Detect head), inside the bound
L640_GFLOPS, TOL_GFLOPS = 224.343, 1e-3
TOL_IMPORT_PX = 1e-3  # boxes of the imported checkpoint, as phase 6 holds them
# the reference's model class, stood in for by the port's graph: unpickling
# a reference checkpoint needs it on sys.path (export_torch_ckpt --repo)
REFERENCE_YOLO = """
from multispectral_object_detection_tpu_torch.models.model import (
    DetectionModel)
from multispectral_object_detection_tpu_torch.models.parser import (
    parse_model_config)


class Model(DetectionModel):
    def __init__(self, cfg, nc):
        super().__init__(parse_model_config(cfg, nc=nc))
"""


def _profile_11a() -> dict:
    """11a: tools/profile_model.py at l@640 bs16, default and --c3-kernel:
    K1's 168 and K2's 84 launches per forward, the kinds summing to the
    device time."""
    from multispectral_object_detection_tpu_torch.tools import (
        profile_model as pm)

    out = {}
    for flag in ([], ["--c3-kernel"]):
        name = " ".join(flag) or "default"
        print(f"profile_model {name}:")
        res = pm.run(pm.parse_args(["--iters", str(PROFILE_ITERS), "--top",
                                    "8"] + flag))
        kinds = res["by_kind"]
        cft = kinds["CFT kernels"]["launches"]
        c3 = kinds["C3 kernel (K2)"]["launches"]
        total = sum(v["ms"] for v in kinds.values())
        print(f"profile_model {name}: CFT {cft} launches per forward, K2 "
              f"{c3}; kinds sum to {total:.3f} of {res['device_ms']:.3f} ms")
        check(cft == 168, f"profile_model {name}: {cft} CFT launches != 168")
        check(c3 == (84 if flag else 0),
              f"profile_model {name}: {c3} K2 launches")
        check(abs(total - res["device_ms"]) <= 1e-6 * res["device_ms"],
              f"profile_model {name}: kinds {total} != {res['device_ms']}")
        out[name] = {k: res[k] for k in ("device_ms", "host_ms", "idle",
                                         "launches", "by_kind")}
    return out


def _mfu_11b(torch, legs: dict, train: dict) -> dict:
    """11b: tools/mfu.py at l@640 on the card: the forward's FLOPs against
    model_info's count, the MFU of phase 4's default leg and of phase 8's
    train steps (remat none and blocks), against the card's peak."""
    from multispectral_object_detection_tpu_torch.tools import mfu

    fwd = mfu.run(mfu.parse_args([]))
    gf = fwd["gflops_per_pair"]
    print(f"mfu l@640 forward: {gf:.3f} GFLOPs per pair ({fwd['counted']}); "
          f"peak {fwd['peak_tflops']} TFLOP/s (dense bf16) for "
          f"{torch.cuda.get_device_name(0)} [{fwd['card']}]")
    check(abs(gf / L640_GFLOPS - 1) <= TOL_GFLOPS,
          f"mfu: {gf} GFLOPs per pair, expected {L640_GFLOPS}")
    rate = legs["default"]["value"]
    leg = mfu.result(mfu.parse_args(["--pairs-per-s", str(rate)]), gf * 1e9,
                     fwd["peak_tflops"] * 1e12, fwd["card"])
    print(f"mfu bench default leg: {rate:.1f} pairs/s -> "
          f"{leg['achieved_tflops']:.2f} TFLOP/s, MFU {leg['mfu_pct']:.2f} %")
    out = {"forward": fwd, "default_leg": leg}
    for remat in ("none", "blocks"):
        ms = train[remat]["ms_per_step"]
        r = mfu.run(mfu.parse_args(["--train", "--batch", str(TRAIN_BATCH),
                                    "--remat", remat, "--ms-per-step",
                                    str(ms)]))
        print(f"mfu train step l@{TRAIN_IMG} bs{TRAIN_BATCH} remat {remat}: "
              f"{r['gflops_per_step']:.1f} GFLOPs per step "
              f"({r['gflops_per_pair'] / gf:.2f} x the forward per pair), "
              f"{ms:.3f} ms -> {r['achieved_tflops']:.2f} TFLOP/s, MFU "
              f"{r['mfu_pct']:.2f} %")
        out[f"train_{remat}"] = r
        torch.cuda.empty_cache()
    ratio = out["train_none"]["gflops_per_pair"] / gf
    check(2.5 <= ratio <= 3.5 and out["train_blocks"]["gflops_per_step"]
          > out["train_none"]["gflops_per_step"],
          f"mfu: train step {ratio:.2f} x the forward, or blocks not above")
    return out


def _resume_11c(torch, run_of_8: dict) -> dict:
    """11c: phase 8's 2-epoch train CLI run raised to 3 epochs in its
    opt.yaml (its data, passed as a dict, written as a flat data YAML) and
    continued by tools/resume_runs.py at epoch 2, K1 in its eval."""
    import logging

    from multispectral_object_detection_tpu_torch.data.hyps import (
        dump_flat_yaml, load_flat_yaml)
    from multispectral_object_detection_tpu_torch.tools import resume_runs

    run, tmp = run_of_8["run"], run_of_8["tmp"]
    (tmp / "data.yaml").write_text(dump_flat_yaml(run_of_8["data"]))
    opt = load_flat_yaml((run / "opt.yaml").read_text())
    check(opt["epochs"] == 2, f"opt.yaml of {run.name}: {opt['epochs']}")
    opt.update(epochs=3, data=str(tmp / "data.yaml"))
    (run / "opt.yaml").write_text(dump_flat_yaml(opt))
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    root = logging.getLogger()
    level = root.level
    root.setLevel(logging.INFO)  # the train CLI's "resumed from" line
    root.addHandler(handler)
    l0 = kernel_launches()
    t0 = time.perf_counter()
    try:
        res = resume_runs.resume_all(str(run.parent))
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    r = res.get(str(run))
    check(list(res) == [str(run)] and isinstance(r, dict),
          f"resume_runs: {res}")
    said = f"resumed from {run / 'last'} at epoch 2"
    meta = json.loads((run / "last" / "meta.json").read_text())
    lines = (run / "results.txt").read_text().splitlines()
    k1 = k1_launches(l0)
    print(f"resume_runs: {run.name} in {secs:.1f} s; {lines[-1]}")
    print(f"resume_runs: eval {r['eval_forwards']} EMA forwards, {k1} K1 "
          f"launches (168 per forward)")
    check(any(said in m for m in records), f"no '{said}' in the log")
    check(meta["epoch"] == 2 and len(lines) == 3
          and lines[2].split()[1] == "2/2" and "mAP50" in lines[2],
          f"resumed run: meta {meta}, results {lines}")
    check(r["eval_forwards"] > 0 and k1 == 168 * r["eval_forwards"]
          and kernel_launches(l0)["c3_bottleneck"] == 0,
          f"resumed eval: K1 {k1} for {r['eval_forwards']} forwards")
    return {"seconds_run": secs, "eval_forwards": r["eval_forwards"],
            "k1_launches": k1, "results": lines}


def _dataset_11d(tmp: Path) -> dict:
    """11d: tools/dataset_tools.py on the 64 PNG pairs phase 5 writes (the
    same generator and seed), the card's route (no cv2: PNG crops)."""
    import numpy as np

    from multispectral_object_detection_tpu_torch.data.datasets import (
        image_to_label_path, read_label_file)
    from multispectral_object_detection_tpu_torch.data.imageio import imread
    from multispectral_object_detection_tpu_torch.data.synthetic import (
        make_paired_dataset)
    from multispectral_object_detection_tpu_torch.tools import (
        dataset_tools as dt)

    root = tmp / "eval_set"
    make_paired_dataset(str(root), n_images=EVAL_IMAGES, nc=1, seed=0,
                        img_hw=EVAL_HW)
    splits = dt.autosplit(str(root))
    counts = {k: len(v) for k, v in splits.items()}
    check(sum(counts.values()) == 2 * EVAL_IMAGES, f"autosplit: {counts}")
    with _without("cv2"):  # the card's route, whether cv2 is there or not
        crops = dt.extract_boxes(str(root))
    rows = differ = 0
    for src in sorted((root / "rgb" / "images").glob("*.png")):
        lab, _ = read_label_file(image_to_label_path(str(src)))
        im = imread(src)
        h, w = im.shape[:2]
        for j, row in enumerate(lab):
            b = row[1:] * np.array([w, h, w, h])
            x1, y1 = int(max(b[0] - b[2] / 2, 0)), int(max(b[1] - b[3] / 2, 0))
            x2, y2 = int(min(b[0] + b[2] / 2, w)), int(min(b[1] + b[3] / 2, h))
            crop = imread(tmp / "classifier" / str(int(row[0]))
                          / f"{src.stem}_{j}.png")
            differ += not np.array_equal(crop, im[y1:y2, x1:x2])
            rows += 1
    n = dt.flatten_recursive(str(root / "rgb"))
    files = [p for p in (root / "rgb").rglob("*") if p.is_file()]
    flat = Path(str(root / "rgb") + "_flat")
    copied = sum((flat / p.name).read_bytes() == p.read_bytes()
                 for p in files)
    print(f"dataset_tools: autosplit {counts}; extract-boxes {len(crops)} "
          f"PNG crops for {rows} label rows, {differ} differing from their "
          f"source regions; flatten {n} files, {copied} of {len(files)} "
          f"byte-equal")
    check(rows == len(crops) and differ == 0
          and all(p.suffix == ".png" for p in crops),
          f"extract-boxes: {len(crops)} crops, {rows} rows, {differ} differ")
    check(n == copied == len(files) == 2 * EVAL_IMAGES, "flatten")
    return {"splits": counts, "crops": len(crops), "flattened": n}


def _import_11e(torch, device, tmp: Path) -> dict:
    """11e: a pickled reference-style checkpoint ({'model', 'ema'}, half
    precision, its class in a --repo directory) of the l model through
    tools/export_torch_ckpt.py to a .pt, read by load_inference_params into
    Detector: the state dict bit-equal to the source's (read as fp32), the
    boxes of Detector.infer equal to those of a Detector built from the
    source."""
    import numpy as np

    from multispectral_object_detection_tpu_torch.hub import Detector
    from multispectral_object_detection_tpu_torch.models.configs import (
        get_config)
    from multispectral_object_detection_tpu_torch.models.model import (
        init_weights)
    from multispectral_object_detection_tpu_torch.tools import (
        export_torch_ckpt)
    from multispectral_object_detection_tpu_torch.utils.checkpoint import (
        load_inference_params)

    repo = tmp / "reference"
    (repo / "models").mkdir(parents=True)
    (repo / "models" / "__init__.py").write_text("")
    (repo / "models" / "yolo.py").write_text(REFERENCE_YOLO)
    cfg_name = "yolov5l_fusion_transformerx3"
    t0 = time.perf_counter()
    sys.path.insert(0, str(repo))
    try:
        from models.yolo import Model

        with torch.device(device):  # a faster init than on the host
            m = Model(get_config(cfg_name, nc=1), nc=1)
        init_weights(m, torch.Generator(device=device).manual_seed(0))
        m.half()  # as the reference saves it
        src = {k: (v.float() if v.is_floating_point() else v).cpu()
               for k, v in m.state_dict().items()}
        torch.save({"epoch": 0, "model": m, "ema": m}, tmp / "best.pt")
    finally:
        sys.path.remove(str(repo))
        for k in [k for k in sys.modules if k.split(".")[0] == "models"]:
            del sys.modules[k]
    del m
    t1 = time.perf_counter()
    rc = export_torch_ckpt.main(["--pt", str(tmp / "best.pt"), "--repo",
                                 str(repo), "--out", str(tmp / "best_sd.pt")])
    t2 = time.perf_counter()
    check(rc == 0, f"export_torch_ckpt exited {rc}")
    sd = load_inference_params(tmp / "best_sd.pt")
    same = sorted(sd) == sorted(src) and all(
        sd[k].dtype == src[k].numpy().dtype
        and sd[k].tobytes() == src[k].numpy().tobytes() for k in src)
    gen = torch.Generator(device=device).manual_seed(13)
    rgb, ir = (torch.randint(0, 256, (BATCH, IMG, IMG, 3), dtype=torch.uint8,
                             device=device, generator=gen) for _ in range(2))
    outs = []
    for kw in ({"weights": str(tmp / "best_sd.pt")}, {"state_dict": src}):
        det = Detector(cfg_name, nc=1, img_size=IMG, conf=SERVE_CONF,
                       device=device, **kw)
        outs.append(det.infer(rgb, ir))
        del det
    torch.cuda.synchronize()
    a, b = outs
    valid_equal = bool(torch.equal(a.valid, b.valid))
    d_px = float((a.boxes - b.boxes)[a.valid].abs().max()) \
        if valid_equal and bool(a.valid.any()) else float("inf")
    print(f"export_torch_ckpt: pickled l@640 checkpoint (half) written in "
          f"{t1 - t0:.1f} s, exported to .pt in {t2 - t1:.1f} s; {len(sd)} "
          f"tensors, bit-equal to the source: {same}; Detector.infer boxes "
          f"({int(a.valid.sum())} valid) max |d| {d_px:.3g} px against the "
          f"source's (tol {TOL_IMPORT_PX})")
    check(same, "imported state dict differs from the source's")
    check(valid_equal and d_px <= TOL_IMPORT_PX,
          f"imported Detector boxes differ: {d_px}")
    torch.cuda.empty_cache()
    return {"tensors": len(sd), "bit_equal": same, "max_box_px": d_px,
            "valid": int(a.valid.sum())}


def _model_yaml_11f(torch, tmp: Path) -> dict:
    """11f: the train CLI with ``--cfg`` the reference-grammar YAML of the
    l model (tests/data), PyYAML unimportable: one epoch of one step
    (TRAIN_BATCH synthetic pairs at TRAIN_IMG) and its eval, K1's 168
    launches per eval forward."""
    from multispectral_object_detection_tpu_torch.cli import train_cli
    from multispectral_object_detection_tpu_torch.data.synthetic import (
        make_paired_dataset)

    cfg = Path(__file__).resolve().parent / "tests" / "data" / \
        "yolov5l_fusion_transformerx3.yaml"
    rgb, ir = make_paired_dataset(str(tmp / "yaml_data"),
                                  n_images=TRAIN_BATCH, img_size=TRAIN_IMG,
                                  nc=1, seed=9)
    with _without("yaml"):
        args = train_cli.parse_args(
            ["--data", "unused", "--cfg", str(cfg), "--epochs", "1",
             "--img-size", str(TRAIN_IMG), "--batch-size", str(TRAIN_BATCH),
             "--nosave", "--project", str(tmp / "yaml_runs")])
        args.data = {"train_rgb": rgb, "train_ir": ir, "val_rgb": rgb,
                     "val_ir": ir, "nc": 1, "names": ["a"]}
        l0 = kernel_launches()
        t0 = time.perf_counter()
        r = train_cli.run(args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    k1 = k1_launches(l0)
    line = (Path(r["save_dir"]) / "results.txt").read_text().strip()
    print(f"  11f train CLI --cfg {cfg.name} without PyYAML, 1 step of "
          f"l@{TRAIN_IMG} bs{TRAIN_BATCH} and its eval in {secs:.1f} s: "
          f"{line}")
    check("mAP50" in line and all(math.isfinite(r[k]) for k in
                                  ("mp", "mr", "map50", "map")),
          f"11f: {r}")
    check(r["eval_forwards"] > 0 and k1 == 168 * r["eval_forwards"],
          f"11f: K1 launches {k1} != 168 x {r['eval_forwards']}")
    return {"s_with_build": secs, "eval_forwards": r["eval_forwards"],
            "k1_launches": k1, "results": line}


def phase_tools(torch, device, card: str, legs: dict, train: dict,
                run_of_8: dict) -> dict:
    """Phase 11: the port's tools on the card."""
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tools_"))
    out = {"card": card}
    try:
        for key, fn in (("profile", _profile_11a),
                        ("mfu", lambda: _mfu_11b(torch, legs, train)),
                        ("resume", lambda: _resume_11c(torch, run_of_8)),
                        ("dataset_tools", lambda: _dataset_11d(tmp)),
                        ("ckpt_import", lambda: _import_11e(torch, device,
                                                           tmp)),
                        ("model_yaml", lambda: _model_yaml_11f(torch, tmp))):
            t0 = time.perf_counter()
            out[key] = fn()
            out[key]["seconds"] = time.perf_counter() - t0
            print(f"  11 {key}: {out[key]['seconds']:.1f} s")
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs one GPU",
              file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from multispectral_object_detection_tpu_torch import kernels
    from multispectral_object_detection_tpu_torch.ops import c3_bottleneck as k2
    from multispectral_object_detection_tpu_torch.ops import cft_stack as cs

    t_start = time.perf_counter()
    device = torch.device("cuda:0")
    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    logs = kernels.build()
    print(f"phase 1: built {len(logs)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        regs = [ln.split("ptxas info    : ")[-1] for ln in log.splitlines()
                if "registers" in ln or ("spill" in ln and " 0 bytes spill"
                                         not in ln)]
        print(f"  {name}: {'; '.join(regs)}")

    worst = phase_checks(torch, cs, k2, device)
    k3_worst = phase_k3_checks(torch, device)
    k4_worst = phase_k4_checks(torch, device)
    print("phase 2: every kernel matches its plain version")
    det, batches, stages, launches = phase_main_path(torch, device)
    k4_serve = phase_k4_serving(torch, device)
    print("phase 3: main path and the DETR cell's path served through the "
          "kernels")
    legs, k2_launches = phase_bench(torch, device)
    launches.update(k2_launches)
    print(f"phase 4: {len(legs)} bench legs ran through the kernels")
    eval_runs = phase_eval(torch, device)
    print(f"phase 5: {sum(k != 'nms_batch' for k in eval_runs)} eval runs "
          f"through the kernels")
    serving = phase_serving(torch, device)
    print("phase 6: Detector.__call__, the detect CLI and the REST service "
          "served through the kernels")
    rows, xrows = phase_timing(torch, F, cs, k2, device, det, batches,
                               stages, card)
    k3_rows = k3_timing(torch, device, card)
    k4_rows = k4_timing(torch, device, card)
    del det, batches, stages
    torch.cuda.empty_cache()
    train, run_of_8 = phase_train(torch, device, card)
    print(f"phase 8: training on the card in {train['seconds']:.1f} s")
    try:
        par = phase_parallel_aug(torch, device, card)
        print(f"phase 9: device augmentation, --quad, --evolve and the "
              f"parallel path in {par['seconds']:.1f} s")
        tail = phase_long_tail(torch, device)
        print(f"phase 10: the hub zoo, Grad-CAM, export, profiling, plots and "
              f"loggers in {tail['seconds']:.1f} s")
        tools = phase_tools(torch, device, card, legs, train, run_of_8)
        print(f"phase 11: profile_model, mfu, resume_runs, dataset_tools, "
              f"export_torch_ckpt and a model YAML path in "
              f"{tools['seconds']:.1f} s")
    finally:
        shutil.rmtree(run_of_8["tmp"], ignore_errors=True)

    out = []
    for name, (source, replaces) in KERNELS.items():
        r = xrows["c3_bottleneck"] if name == "c3_bottleneck_x" else rows[name]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": worst[name], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    k3 = k3_rows["B32_K20160"]
    out.append({**K3, "launches": launches["nms_suppress"],
                "max_abs_err": k3_worst, "ms": k3["ms"],  # slots differing
                "plain_ms": k3["plain_ms"], "bound_ms": k3["bytes_bound_ms"],
                "bound_by": "bytes; in fact the chain of dependent picks",
                "library_ms": None, "us_per_pick": k3["us_per_pick"]})
    k4 = k4_rows["forward"]
    out.append({**K4, "launches": k4_serve["launches"],  # one infer call
                "max_abs_err": k4_worst,  # max |K4 - plain| / max |plain|
                "ms": k4["ms"], "plain_ms": k4["plain_ms"],
                "bound_ms": k4["bound_ms"], "bound_by": "encoder "
                f"{k4_rows['encoder']['bound_by']}, decoder "
                f"{k4_rows['decoder']['bound_by']}; in fact the gathered "
                "corners through L1 and L2",
                "bench_bound_ms": k4["bench_bound_ms"],
                "library_ms": k4["plain_ms"],  # the plain path is grid_sample
                "encoder_ms": k4_rows["encoder"]["ms"],
                "decoder_ms": k4_rows["decoder"]["ms"]})
    print(json.dumps({"eval": eval_runs}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"train": train}))
    print(json.dumps({"parallel_aug": par}))
    print(json.dumps({"long_tail": tail}))
    print(json.dumps({"tools": tools}))
    print(json.dumps({"kernels": out}))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
