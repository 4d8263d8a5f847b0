"""Paired-folder inference CLI of the port, the counterpart of
``detect_twostream.py`` (multispectral_object_detection_tpu/cli/
detect_cli.py): the same flags, label files and pipeline, on the GPU.

    python -m multispectral_object_detection_tpu_torch.cli.detect_cli \\
        --weights <checkpoint dir or .pt> --source1 <RGB> --source2 <IR>

It walks two aligned image folders (or videos, webcams and streams, which
need cv2), letterboxes on the host, runs forward + decode + NMS on the
device, rescales the boxes to native pixels and writes annotated images
(JPEG with cv2, else PNG without labels) and YOLO-format txt files.
Three stages overlap: a producer thread decodes and letterboxes, the
device computes one batch while the main thread writes the previous
one's results, and the short final batch is padded to the batch size.
``--nosave`` without ``--save-crop`` is the headless path: images are
decoded straight to the network scale (``load_scaled``) and the prescale
is folded into the box ratio. ``--device`` defaults to CUDA and fails
without a GPU; ``--device cpu`` runs on the CPU. ``run`` returns
{"n_images", "n_det", "fps", "fps_steady"}.

``--update`` strips each checkpoint directory of ``--weights`` to its EMA
weights (``model.pt``, utils/checkpoint.strip_checkpoint) after the run.

Divergence from the JAX CLI: ``--nc`` defaults to the config's own class
count (the JAX default of 1 overrides it).
"""

from __future__ import annotations

import argparse
import logging
import queue
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger(__name__)

# BGR, as the JAX CLI draws them on cv2's BGR frames; the port's frames
# are RGB, so they are drawn reversed and the written files agree
PALETTE = [(255, 56, 56), (56, 168, 255), (56, 255, 106), (255, 200, 56),
           (186, 56, 255), (255, 112, 31), (56, 255, 255), (255, 56, 170)]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        "python -m multispectral_object_detection_tpu_torch.cli.detect_cli")
    ap.add_argument("--cfg", type=str, default="yolov5l_fusion_transformerx3")
    ap.add_argument("--weights", type=str, required=True, nargs="+",
                    help="checkpoint dir(s) or .pt state dict(s); several = "
                         "an ensemble of members of one --cfg")
    ap.add_argument("--ensemble-mode", type=str, default="cat",
                    choices=["cat", "mean", "max", "ds", "ds-li", "ds-sun"],
                    help="how ensemble members combine before NMS: cat, "
                         "mean/max per anchor, ds* = Dempster-Shafer "
                         "evidence fusion (ops/ds_fusion.py)")
    ap.add_argument("--source1", type=str, required=True,
                    help="RGB folder, listing, image, video or stream")
    ap.add_argument("--source2", type=str, default="",
                    help="IR counterpart of --source1")
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--conf-thres", type=float, default=0.4)
    ap.add_argument("--iou-thres", type=float, default=0.45)
    ap.add_argument("--max-det", type=int, default=300)
    ap.add_argument("--nc", type=int, default=None,
                    help="class count (default: the config's own)")
    ap.add_argument("--names", type=str, default="",
                    help="comma-separated class names")
    ap.add_argument("--classes", type=int, nargs="*", default=None)
    ap.add_argument("--agnostic-nms", action="store_true")
    ap.add_argument("--merge-nms", action="store_true",
                    help="weighted box merging")
    ap.add_argument("--augment", action="store_true",
                    help="test-time augmentation: 3 scales + lr flip")
    ap.add_argument("--project", type=str, default="runs/detect")
    ap.add_argument("--name", type=str, default="exp")
    ap.add_argument("--exist-ok", action="store_true")
    ap.add_argument("--save-txt", action="store_true")
    ap.add_argument("--save-conf", action="store_true")
    ap.add_argument("--save-crop", action="store_true",
                    help="save detection crops (utils/general.save_one_box)")
    ap.add_argument("--nosave", action="store_true")
    ap.add_argument("--batch-size", type=int, default=1,
                    help="pairs per device dispatch")
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--no-fuse", action="store_true",
                    help="keep live BatchNorm instead of conv-folded "
                         "inference")
    ap.add_argument("--line-thickness", type=int, default=2)
    ap.add_argument("--hide-labels", action="store_true")
    ap.add_argument("--hide-conf", action="store_true")
    ap.add_argument("--int8", action="store_true",
                    help="weights-only int8: conv weights stored int8 + a "
                         "per-channel scale (models/quantize.py)")
    ap.add_argument("--device", type=str, default="",
                    help="'' = cuda (fails without a GPU), 'cpu', 'cuda:N' "
                         "or a CUDA index N")
    ap.add_argument("--update", action="store_true",
                    help="strip the checkpoint directories of --weights to "
                         "inference-only (model.pt, the EMA weights) after "
                         "the run")
    ap.add_argument("--view-img", action="store_true",
                    help="accepted for compatibility; results are written "
                         "to the run dir")
    return ap.parse_args(argv)


class _ShapeOnly:
    """Stand-in for a decoded image when only its dimensions are needed
    (the headless path never materialises full-resolution pixels)."""

    def __init__(self, h: int, w: int):
        self.shape = (h, w, 3)


def build_forward(args, device: torch.device):
    """The models, the class count and ``forward(rgb, ir)``: uint8 (B, S, S,
    3) tensors on the device -> Detections on the canvas."""
    from ..hub import create
    from ..ops.nms import batched_nms
    from ..train.eval_forward import (make_eval_forward,
                                      make_eval_forward_ensemble,
                                      make_eval_forward_tta)

    if len(args.weights) > 1 and (args.augment or args.int8):
        raise SystemExit("--augment/--int8 are single-checkpoint; drop them "
                         "or pass one --weights")
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    if args.cfg.endswith((".yaml", ".yml")):
        cfg = args.cfg
    else:
        from ..models.configs import get_config

        cfg = get_config(args.cfg, nc=args.nc)
    models = [create(cfg, args.nc, weights=w, dtype=dtype, device=device,
                     fuse=not args.no_fuse, int8=args.int8)
              for w in args.weights]
    nc = models[0].spec.nc
    if len(models) > 1:
        logger.info(f"ensemble of {len(models)} checkpoints "
                    f"(mode={args.ensemble_mode})")
        fwd = make_eval_forward_ensemble(models, args.ensemble_mode)
    elif args.augment:
        fwd = make_eval_forward_tta(models[0])
    else:
        fwd = make_eval_forward(models[0])
    class_mask = None
    if args.classes is not None:
        class_mask = torch.zeros(nc, dtype=torch.bool, device=device)
        class_mask[list(args.classes)] = True

    @torch.inference_mode()
    def forward(rgb, ir):
        return batched_nms(fwd(rgb, ir)[0], conf_thres=args.conf_thres,
                           iou_thres=args.iou_thres, multi_label=False,
                           agnostic=args.agnostic_nms, max_det=args.max_det,
                           top_k=1024, class_mask=class_mask,
                           merge=args.merge_nms)

    return models, nc, forward


def _sources(args):
    """(is_video, the producer's iterator of ((path, rgb), (path, ir)) for
    the full path, the image path lists or None)."""
    from ..data.datasets import list_images
    from ..data.imageio import imread
    from ..data.sources import VID_EXTS, MediaSource, is_stream

    is_video = Path(args.source1).suffix.lower() in VID_EXTS or \
        is_stream(args.source1)
    if is_video:
        src1 = iter(MediaSource(args.source1))
        src2 = iter(MediaSource(args.source2)) if args.source2 else None
        frames = zip(src1, src2) if src2 else ((a, a) for a in src1)
        pairs = (((n1, np.ascontiguousarray(f1)),
                  (n2, np.ascontiguousarray(f2)))
                 for (n1, f1, _), (n2, f2, _) in frames)
        return True, pairs, None
    files1 = list_images(args.source1)
    files2 = list_images(args.source2) if args.source2 else files1
    if len(files1) != len(files2):
        raise ValueError(f"paired sources must align: {len(files1)} RGB vs "
                         f"{len(files2)} IR images")
    pairs = (((p1, imread(p1)), (p2, imread(p2)))
             for p1, p2 in zip(files1, files2))
    return False, pairs, (files1, files2)


def run(args) -> dict:
    from ..data.augment import letterbox, load_scaled
    from ..utils.general import (check_img_size, device_from_arg, draw_box,
                                 increment_path, save_one_box, write_image)

    if args.update:
        files = [w for w in args.weights if not Path(w).is_dir()]
        if files:
            raise SystemExit(f"detect_cli: --update strips checkpoint "
                             f"directories; {files[0]} is not one")
    device = device_from_arg(args.device)
    if args.view_img:
        logger.info("--view-img: results are written to the run dir instead "
                    "of a display window")
    s = check_img_size(args.img_size, 32)
    save_dir = increment_path(Path(args.project) / args.name,
                              exist_ok=args.exist_ok)
    (save_dir / "labels" if args.save_txt else save_dir).mkdir(
        parents=True, exist_ok=True)
    _, nc, forward = build_forward(args, device)
    names = (args.names.split(",") if args.names
             else [str(i) for i in range(nc)])
    is_video, pairs, files = _sources(args)

    B = max(args.batch_size, 1)
    headless = args.nosave and not args.save_crop and not is_video

    def producer(q):
        try:
            if headless:
                for p1, p2 in zip(*files):
                    im, (h0, w0) = load_scaled(p1, s)
                    irs, _ = load_scaled(p2, s)
                    h1, w1 = im.shape[:2]
                    rgb, (r, _), pad = letterbox(im, (s, s))
                    ir, _, _ = letterbox(irs, (s, s))
                    # the decode-time prescale folded into the ratio, so
                    # boxes rescale to the original (h0, w0)
                    ratio = (r * w1 / w0, r * h1 / h0)
                    shp = _ShapeOnly(h0, w0)
                    q.put(((p1, shp, p2, shp, ratio, pad), rgb, ir))
                return
            for (p1, im0), (p2, ir0) in pairs:
                rgb, ratio, pad = letterbox(im0, (s, s))
                ir, _, _ = letterbox(ir0, (s, s))
                q.put(((p1, im0, p2, ir0, ratio, pad), rgb, ir))
        except BaseException as e:  # handed to the consumer, re-raised
            q.put(e)
        finally:
            q.put(None)

    q: "queue.Queue" = queue.Queue(maxsize=3 * B)
    threading.Thread(target=producer, args=(q,), daemon=True).start()

    n_det_total = 0
    n_frames = 0
    writer = None
    t_wall0 = time.perf_counter()

    def emit(meta, det, i):
        nonlocal n_det_total, n_frames, writer
        p1, im0, p2, ir0, ratio, pad = meta
        n_frames += 1
        boxes, scores, classes, valid = (a[i] for a in det)
        boxes, scores, classes = boxes[valid], scores[valid], classes[valid]
        # rescale to native pixels
        boxes[:, [0, 2]] = (boxes[:, [0, 2]] - pad[0]) / ratio[0]
        boxes[:, [1, 3]] = (boxes[:, [1, 3]] - pad[1]) / ratio[1]
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, im0.shape[1])
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, im0.shape[0])
        n_det_total += len(boxes)

        stem = Path(p1).stem if not is_video else f"frame{n_frames:06d}"
        if args.save_txt:
            h0, w0 = im0.shape[:2]
            lines = []
            for b, sc, c in zip(boxes, scores, classes):
                cx, cy = (b[0] + b[2]) / 2 / w0, (b[1] + b[3]) / 2 / h0
                bw, bh = (b[2] - b[0]) / w0, (b[3] - b[1]) / h0
                row = (int(c), cx, cy, bw, bh) + (
                    (float(sc),) if args.save_conf else ())
                lines.append(" ".join(f"{v:.6g}" if isinstance(v, float)
                                      else str(v) for v in row))
            (save_dir / "labels" / f"{stem}.txt").write_text("\n".join(lines))
        if args.save_crop:
            # crops come from the clean image, before the boxes are drawn
            for k, (b, c) in enumerate(zip(boxes, classes)):
                save_one_box(b, im0, file=save_dir / "crops" / names[int(c)]
                             / f"{stem}_{k}.jpg")
        if not args.nosave:
            lt = args.line_thickness
            for b, sc, c in zip(boxes, scores, classes):
                color = PALETTE[int(c) % len(PALETTE)][::-1]
                txt = None if args.hide_labels else (
                    names[int(c)] if args.hide_conf
                    else f"{names[int(c)]} {sc:.2f}")
                for img in (im0, ir0):
                    draw_box(img, b, color, lt, txt)
            if is_video:
                import cv2  # the source was read by cv2 too

                if writer is None:
                    writer = cv2.VideoWriter(
                        str(save_dir / "output.mp4"),
                        cv2.VideoWriter_fourcc(*"mp4v"), 25,
                        (im0.shape[1], im0.shape[0]))
                writer.write(np.ascontiguousarray(im0[:, :, ::-1]))
            else:
                write_image(save_dir / f"{stem}_rgb.jpg", im0)
                write_image(save_dir / f"{stem}_ir.jpg", ir0)

    def collect():
        """Queue items grouped into batches of B (the last may be short)."""
        buf = []
        while True:
            item = q.get()
            if isinstance(item, BaseException):
                raise item
            if item is None:
                if buf:
                    yield buf
                return
            buf.append(item)
            if len(buf) == B:
                yield buf
                buf = []

    pending = None  # one batch in flight on the device
    t_steady0 = None  # set once the first batch is out (first uses)
    n_at_steady = 0
    stream = collect()
    done = False
    while not done:
        buf = next(stream, None)
        nxt = None
        if buf is not None:
            metas = [m for m, _, _ in buf]
            rgb_b = np.stack([r for _, r, _ in buf])
            ir_b = np.stack([r for _, _, r in buf])
            if len(buf) < B:  # pad the short final batch: one batch shape
                padn = [(0, B - len(buf))] + [(0, 0)] * 3
                rgb_b = np.pad(rgb_b, padn)
                ir_b = np.pad(ir_b, padn)
            nxt = (metas, forward(torch.from_numpy(rgb_b).to(device),
                                  torch.from_numpy(ir_b).to(device)))
        if pending is not None:
            p_metas, p_det = pending
            # one device-to-host copy per batch
            p_det = [t.cpu().numpy() for t in p_det]
            for i, m in enumerate(p_metas):
                emit(m, p_det, i)  # overlaps the device's next batch
            if t_steady0 is None:
                t_steady0 = time.perf_counter()
                n_at_steady = n_frames
        pending = nxt
        done = nxt is None

    if writer is not None:
        writer.release()
    t_wall = time.perf_counter() - t_wall0
    fps = n_frames / t_wall if t_wall > 0 else 0.0
    # steady state leaves out the first batch (first uses of every kernel)
    t_steady = (time.perf_counter() - t_steady0) if t_steady0 else 0.0
    fps_steady = ((n_frames - n_at_steady) / t_steady
                  if t_steady > 0 and n_frames > n_at_steady else fps)
    logger.info(f"{n_frames} pairs, {n_det_total} detections, "
                f"{fps:.1f} FPS end-to-end ({fps_steady:.1f} steady-state) "
                f"-> {save_dir}")
    if args.update:
        from ..utils.checkpoint import strip_checkpoint

        for w in args.weights:
            logger.info(f"--update: stripped {w} -> {strip_checkpoint(w)}")
    return {"n_images": n_frames, "n_det": n_det_total, "fps": fps,
            "fps_steady": fps_steady, "save_dir": str(save_dir)}


def main(argv=None) -> int:
    from ..utils.general import device_from_arg

    logging.basicConfig(format="%(message)s", level=logging.INFO)
    args = parse_args(argv)
    try:
        device_from_arg(args.device)
    except RuntimeError as e:
        print(f"detect_cli: {e}", file=sys.stderr)
        return 1
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
