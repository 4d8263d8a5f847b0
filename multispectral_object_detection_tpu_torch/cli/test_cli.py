"""Evaluation CLI of the port, the counterpart of ``test.py``
(multispectral_object_detection_tpu/cli/test_cli.py): the same flags and
defaults, on the GPU.

    python -m multispectral_object_detection_tpu_torch.cli.test_cli \\
        --data data.yaml --weights <checkpoint dir or .pt> [...]

Tasks: ``val`` (mAP on the val split; ``test`` takes the test split where
the data names one), ``speed`` (forward + decode ms per image) and
``study`` (mAP over image sizes, written to ``study_<cfg>.txt`` and
plotted to ``study.png`` where matplotlib is installed).
Weights are JAX checkpoint directories or ``.pt`` reference-layout state
dicts (utils/checkpoint.py); several make an ensemble. ``--device``
defaults to CUDA and fails without a GPU; ``--device cpu`` runs on the CPU.
``run`` takes the parsed arguments, where ``data`` may also be a dict.

``--compute-loss`` adds the val loss (box, obj, cls) with the trainer's
gains. ``--data-parallel N`` splits each batch over N ranks (forward and
NMS per rank, detections gathered, metrics on rank 0;
parallel/mesh.py): under a launcher (``torchrun --nproc-per-node N``) it
takes the launched ranks, else it starts them itself; NCCL on CUDA, gloo
with ``--device cpu``. ``--plots`` writes the confusion matrix and the
PR, F1, P and R curves into the run directory (utils/plots.py; without
matplotlib it exits before any work); ``--wandb`` logs the metrics and
the first 16 images' detections to W&B (utils/loggers.py; without wandb
it warns and logs nothing).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        "python -m multispectral_object_detection_tpu_torch.cli.test_cli")
    ap.add_argument("--cfg", type=str, default="yolov5l_fusion_transformerx3")
    ap.add_argument("--data", type=str, required=True)
    ap.add_argument("--weights", type=str, required=True, nargs="+",
                    help="checkpoint dir(s) or .pt state dict(s); several = "
                         "an ensemble of members of one --cfg")
    ap.add_argument("--ensemble-mode", type=str, default="cat",
                    choices=["cat", "mean", "max", "ds", "ds-li", "ds-sun"],
                    help="how ensemble members combine before NMS: cat, "
                         "mean/max per anchor, ds* = Dempster-Shafer "
                         "evidence fusion (ops/ds_fusion.py)")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--conf-thres", type=float, default=0.001)
    ap.add_argument("--iou-thres", type=float, default=0.6)
    ap.add_argument("--task", type=str, default="val",
                    choices=["val", "test", "speed", "study"])
    ap.add_argument("--augment", action="store_true",
                    help="test-time augmentation: 3 scales + lr flip")
    ap.add_argument("--single-cls", action="store_true")
    ap.add_argument("--max-labels", type=int, default=300)
    ap.add_argument("--save-json", type=str, default="")
    ap.add_argument("--save-coco", type=str, default="",
                    help="write COCO-format detection JSON and evaluate it "
                         "by the COCO protocol")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--wandb", action="store_true",
                    help="log the metrics and the first 16 val images' "
                         "detections to W&B (warns and skips without "
                         "wandb)")
    ap.add_argument("--entity", type=str, default=None, help="W&B entity")
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--save-txt", action="store_true",
                    help="write labels/<stem>.txt per image: cls and "
                         "normalised xywh in native pixels")
    ap.add_argument("--save-hybrid", action="store_true",
                    help="inject the ground truth into NMS as "
                         "unit-confidence candidates and save the hybrid "
                         "label + prediction txts")
    ap.add_argument("--save-conf", action="store_true",
                    help="append the confidence to --save-txt lines")
    ap.add_argument("--plots", action="store_true",
                    help="write confusion_matrix.png and the PR/F1/P/R "
                         "curves into the run dir (needs matplotlib)")
    ap.add_argument("--project", type=str, default="runs/test")
    ap.add_argument("--name", type=str, default="exp")
    ap.add_argument("--exist-ok", action="store_true")
    ap.add_argument("--no-rect", action="store_true",
                    help="square letterbox instead of rect batches (pad 0.5)")
    ap.add_argument("--compute-loss", action="store_true",
                    help="also report the box/obj/cls loss on the split")
    ap.add_argument("--no-fuse", action="store_true",
                    help="keep live BatchNorm instead of conv-folded "
                         "inference")
    ap.add_argument("--int8", action="store_true",
                    help="weights-only int8 inference: conv weights stored "
                         "int8 + a per-channel scale (models/quantize.py)")
    ap.add_argument("--device", type=str, default="",
                    help="'' = cuda (fails without a GPU), 'cpu', 'cuda:N' "
                         "or a CUDA index N")
    ap.add_argument("--data-parallel", type=int, default=0,
                    help="split eval batches over N ranks (0 = one "
                         "process); started here unless launched")
    return ap.parse_args(argv)


def _load_data(data) -> dict:
    if isinstance(data, dict):
        return data
    from ..data.hyps import read_yaml

    return read_yaml(data)


def _check_flags(args) -> None:
    from ..utils import plots

    if args.plots and not plots.available():
        raise SystemExit(f"test_cli: --plots needs matplotlib: "
                         f"{plots.MISSING}")
    if args.augment and args.compute_loss:
        raise SystemExit("--augment cannot compute the val loss (the TTA "
                         "scales' raw outputs differ in shape); drop "
                         "--compute-loss")
    if args.augment and args.data_parallel > 1:
        raise SystemExit("--augment is single-device; drop --data-parallel")
    if len(args.weights) > 1:
        for on, flag in ((args.augment, "--augment"), (args.int8, "--int8"),
                         (args.compute_loss, "--compute-loss"),
                         (args.data_parallel > 1, "--data-parallel")):
            if on:
                raise SystemExit(f"{flag} is single-checkpoint; drop it or "
                                 f"pass one --weights")
    if args.int8 and args.data_parallel > 1:
        raise SystemExit("--int8 is single-device; drop --data-parallel")
    n = args.data_parallel
    if n > 1 and args.batch_size % n:
        raise SystemExit(f"--batch-size {args.batch_size} must be divisible "
                         f"by --data-parallel {n}")


def build_forward(args, data: dict, device: torch.device):
    """The member models and the forward the CLI runs."""
    from ..hub import create
    from ..train.eval_forward import (make_eval_forward,
                                      make_eval_forward_ensemble,
                                      make_eval_forward_tta)

    nc = 1 if args.single_cls else int(data["nc"])
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    if args.cfg.endswith((".yaml", ".yml")):
        cfg = args.cfg
    else:
        from ..models.configs import get_config

        cfg = get_config(args.cfg, nc=nc)
    models = [create(cfg, nc, weights=w, dtype=dtype, device=device,
                     fuse=not args.no_fuse, int8=args.int8)
              for w in args.weights]
    if len(models) > 1:
        logger.info(f"ensemble of {len(models)} checkpoints "
                    f"(mode={args.ensemble_mode})")
        return models, make_eval_forward_ensemble(models, args.ensemble_mode)
    if args.augment:
        return models, make_eval_forward_tta(models[0])
    return models, make_eval_forward(models[0])


def make_loader(args, data: dict, img_size: int, nc: int):
    from ..data.datasets import BatchLoader, PairedDetectionDataset

    two_stream = "val_ir" in data
    split = "test" if args.task == "test" and "test_rgb" in data else "val"
    ds = PairedDetectionDataset.from_sources(
        data[f"{split}_rgb"] if two_stream else data[split],
        data.get(f"{split}_ir"), img_size=img_size,
        nc=None if args.single_cls else nc, rect=not args.no_rect, pad=0.5)
    if args.single_cls:
        for lab in ds.labels:
            if len(lab):
                lab[:, 0] = 0
    return ds, BatchLoader(ds, args.batch_size, max_labels=args.max_labels)


def run(args) -> dict:
    """Evaluate; returns the result dict (``speed``: {"ms_per_image"};
    ``study``: {size: {"map50", "map"}})."""
    from ..train.evaluator import evaluate
    from ..utils.general import (check_img_size, device_from_arg,
                                 increment_path)

    _check_flags(args)
    device = device_from_arg(args.device)
    shard = None
    if args.data_parallel > 1 and args.task in ("val", "test"):
        from ..parallel import mesh as pm

        n = args.data_parallel
        world, device = pm.init_distributed(device)
        if world == 1:  # no launcher: start the ranks here
            if device.type == "cuda" and torch.cuda.device_count() < n:
                raise SystemExit(f"--data-parallel {n} needs {n} devices, "
                                 f"found {torch.cuda.device_count()}")
            return pm.spawn(n, run, args, backend="nccl"
                            if device.type == "cuda" else "gloo")
        if world != n:
            raise SystemExit(f"--data-parallel {n} but {world} ranks were "
                             f"launched")
        shard = pm.EvalShard(pm.make_mesh(n, 1), args.batch_size)
        logger.info(f"data-parallel eval over {n} ranks")
    if args.task == "study":
        return study_task(args)
    data = _load_data(args.data)
    img_size = check_img_size(args.img_size, 32)
    nc = 1 if args.single_cls else int(data["nc"])
    models, fwd = build_forward(args, data, device)
    ds, loader = make_loader(args, data, img_size, nc)
    if args.task == "speed":
        return speed_task(fwd, loader, device)
    loss_fn = None
    if args.compute_loss:
        from ..models.detect import anchor_arrays
        from ..train.loss import DetectionLoss, LossHyp, scale_gains

        # the trainer's gains, so the val loss is on the training scale
        spec = models[0].spec
        loss_fn = DetectionLoss(nc, anchor_arrays(spec.anchors),
                                spec.strides,
                                scale_gains(LossHyp(), nc=nc,
                                            img_size=img_size,
                                            nl=len(spec.strides)))

    main = shard is None or shard.mesh.is_main
    coco = _save_coco_json(fwd, loader, ds, args, device) \
        if args.save_coco and main else None
    names = data.get("names", [str(i) for i in range(nc)])
    save_dir = per_image = confusion = None
    if (args.save_txt or args.save_hybrid or args.plots) and main:
        save_dir = increment_path(Path(args.project) / args.name,
                                  exist_ok=args.exist_ok)
        save_dir.mkdir(parents=True, exist_ok=True)
    if args.plots and main:
        from ..utils.metrics import ConfusionMatrix

        confusion = ConfusionMatrix(nc=nc)
    if (args.save_txt or args.save_hybrid) and main:
        (save_dir / "labels").mkdir(exist_ok=True)

        def per_image(idx, boxes, scores, classes, native_hw):
            # native xyxy -> normalised xywh lines
            h0, w0 = native_hw
            stem = Path(ds.rgb_files[idx]).stem
            lines = []
            for b, s, c in zip(boxes, scores, classes):
                row = [int(c), (b[0] + b[2]) / 2 / w0, (b[1] + b[3]) / 2 / h0,
                       (b[2] - b[0]) / w0, (b[3] - b[1]) / h0]
                row += [s] if args.save_conf else []
                lines.append(" ".join(str(v) if isinstance(v, int)
                                      else f"{v:.6g}" for v in row))
            (save_dir / "labels" / f"{stem}.txt").write_text(
                "\n".join(lines) + ("\n" if lines else ""))

    xlog = panels = None
    if args.wandb and main:  # W&B bbox-debug panels of the first 16 images
        from ..utils.loggers import ExperimentLogger

        xlog = ExperimentLogger(
            str(save_dir or Path(args.project) / args.name), enable_tb=False,
            enable_wandb=True, run_name=args.name, entity=args.entity)
        if xlog.wandb_run is not None:
            panels = []
            per_image = _with_panels(per_image, panels, ds)

    res = evaluate(fwd, loader, nc=nc, device=device,
                   conf_thres=args.conf_thres, iou_thres=args.iou_thres,
                   single_cls=args.single_cls, hybrid=args.save_hybrid,
                   per_image=per_image, confusion=confusion,
                   curves=args.plots and main, loss_fn=loss_fn, shard=shard)
    if panels:
        xlog.log_bbox_debug_images([p[0] for p in panels],
                                   [p[1] for p in panels], names)
    if xlog is not None:
        xlog.log_scalars({"metrics/precision": res["mp"],
                          "metrics/recall": res["mr"],
                          "metrics/mAP_0.5": res["map50"],
                          "metrics/mAP_0.75": res["map75"],
                          "metrics/mAP_0.5:0.95": res["map"]}, 0)
        xlog.close()
    if confusion is not None:
        _plot_eval(confusion, res.get("curves"), names, save_dir)
    if coco is not None:
        res["coco"] = coco
    if "lamr" in res:
        logger.info(f"log-average miss rate: {res['lamr']:.4f}")
    if "val_loss" in res:
        box, obj, cls = res["val_loss"]
        logger.info(f"val loss: box {box:.5f} obj {obj:.5f} cls {cls:.5f}")
    logger.info(f"{'class':>12} {'P':>8} {'R':>8} {'mAP50':>8} "
                f"{'mAP75':>8} {'mAP':>8}")
    logger.info(f"{'all':>12} {res['mp']:8.3f} {res['mr']:8.3f} "
                f"{res['map50']:8.3f} {res['map75']:8.3f} {res['map']:8.3f}")
    if args.verbose:
        for c, d in res.get("per_class", {}).items():
            nm = names[c] if c < len(names) else str(c)
            logger.info(f"{nm:>12} {d['p']:8.3f} {d['r']:8.3f} "
                        f"{d['ap50']:8.3f} {d['ap75']:8.3f} {d['ap']:8.3f}")
    logger.info(f"speed: {res['t_infer_ms']:.2f} ms infer, "
                f"{res['t_nms_ms']:.2f} ms NMS, {res['t_match_ms']:.2f} ms "
                f"matching per image")
    if args.save_json and main:
        Path(args.save_json).write_text(json.dumps(
            {k: v for k, v in res.items()
             if isinstance(v, (int, float, dict)) and k != "curves"},
            indent=1, default=float))
    return res


def _with_panels(per_image, panels: list, ds):
    """``per_image`` that also keeps the first 16 images with their
    detections, for W&B's bbox-debug panels."""
    from ..data.imageio import imread

    def hook(idx, boxes, scores, classes, native_hw):
        if per_image is not None:
            per_image(idx, boxes, scores, classes, native_hw)
        if len(panels) < 16 and idx < len(ds.rgb_files):
            panels.append((imread(ds.rgb_files[idx]),
                           (boxes, scores, classes)))

    return hook


def _plot_eval(confusion, curves, names, save_dir: Path) -> None:
    """confusion_matrix.png and the PR, F1, P and R curves."""
    from ..utils.plots import (plot_confusion_matrix, plot_mc_curve,
                               plot_pr_curve)

    plot_confusion_matrix(confusion.matrix, names,
                          str(save_dir / "confusion_matrix.png"))
    if curves is not None:
        cls_names = [names[int(c)] if int(c) < len(names) else str(c)
                     for c in curves["cls_ids"]]
        plot_pr_curve(curves["pr_px"], curves["pr_py"], curves["ap"],
                      str(save_dir / "PR_curve.png"), cls_names)
        for key, fname in (("f1", "F1_curve.png"), ("p", "P_curve.png"),
                           ("r", "R_curve.png")):
            plot_mc_curve(curves["px"], curves[key], str(save_dir / fname),
                          cls_names, ylabel=key.upper())
    logger.info(f"plots -> {save_dir}")


def study_task(args) -> dict:
    """mAP over image sizes 256-640; rows [size, P, R, mAP50, mAP,
    infer ms, NMS ms] go to <project>/<name>/study_<cfg>.txt, plotted to
    study.png where matplotlib is installed."""
    from ..utils import plots
    from ..utils.general import increment_path

    results, rows = {}, []
    for sz in (256, 320, 384, 448, 512, 640):
        sub = argparse.Namespace(**vars(args))
        sub.img_size, sub.task = sz, "val"
        sub.save_txt = sub.save_hybrid = sub.plots = False
        sub.save_json = sub.save_coco = ""
        r = run(sub)
        results[sz] = {"map50": r["map50"], "map": r["map"]}
        rows.append([sz, r["mp"], r["mr"], r["map50"], r["map"],
                     r["t_infer_ms"], r["t_nms_ms"]])
        logger.info(f"study @{sz}: mAP50 {r['map50']:.3f}")
    save_dir = increment_path(Path(args.project) / args.name,
                              exist_ok=args.exist_ok)
    save_dir.mkdir(parents=True, exist_ok=True)
    sf = save_dir / f"study_{Path(str(args.cfg)).stem}.txt"
    np.savetxt(sf, np.asarray(rows), fmt="%.5g")
    if plots.available():
        plots.plot_study([str(sf)], str(save_dir / "study.png"))
    else:
        logger.info(f"study plot skipped: {plots.MISSING}")
    logger.info(f"study results -> {sf}")
    return results


def _save_coco_json(fwd, loader, ds, args, device) -> dict:
    """COCO detection records [{image_id, category_id, bbox, score}, ...]
    (bbox xywh from the top-left corner, native pixels) written to
    ``--save-coco``, and their COCO-protocol evaluation against the
    labels."""
    from ..ops.nms import batched_nms
    from ..utils.cocoeval import coco_eval_bbox
    from ..utils.general import coco80_to_coco91_class, rescale_to_native

    is_coco = "coco" in str(args.data).lower()
    c91 = coco80_to_coco91_class()
    jdict, gt_records = [], []
    for batch in loader:
        rgb = torch.from_numpy(batch["rgb"]).to(device)
        ir = torch.from_numpy(batch["ir"]).to(device) if "ir" in batch \
            else rgb
        dets_flat, _ = fwd(rgb, ir)
        det = batched_nms(dets_flat, conf_thres=args.conf_thres,
                          iou_thres=args.iou_thres,
                          multi_label=not args.single_cls,
                          agnostic=args.single_cls)
        boxes_b, scores_b, classes_b, valid_b = (t.cpu().numpy() for t in det)
        H, W = rgb.shape[1:3]
        for si, img_i in enumerate(batch["index"]):
            stem = Path(ds.rgb_files[img_i]).stem
            image_id = int(stem) if stem.isnumeric() else stem
            v = valid_b[si]
            boxes = boxes_b[si][v]
            native_hw, ratio_pad = batch["shapes"][si]
            if len(boxes):
                boxes = rescale_to_native(boxes, (H, W), native_hw, ratio_pad)
            for b, s, c in zip(boxes, scores_b[si][v], classes_b[si][v]):
                jdict.append({
                    "image_id": image_id,
                    "category_id": c91[int(c)] if is_coco else int(c),
                    "bbox": [round(float(b[0]), 3), round(float(b[1]), 3),
                             round(float(b[2] - b[0]), 3),
                             round(float(b[3] - b[1]), 3)],
                    "score": round(float(s), 5)})
            h0, w0 = native_hw
            for row in np.asarray(ds.labels[img_i], np.float32).reshape(-1, 5):
                cls_i = int(row[0])
                gt_records.append({
                    "image_id": image_id,
                    "category_id": c91[cls_i] if is_coco else cls_i,
                    "bbox": [float((row[1] - row[3] / 2) * w0),
                             float((row[2] - row[4] / 2) * h0),
                             float(row[3] * w0), float(row[4] * h0)]})
    Path(args.save_coco).write_text(json.dumps(jdict))
    logger.info(f"wrote {len(jdict)} COCO records -> {args.save_coco}")
    coco = coco_eval_bbox(gt_records, jdict)
    logger.info(f"COCO-protocol bbox eval: AP {coco['AP']:.4f}  AP50 "
                f"{coco['AP50']:.4f}  AP75 {coco['AP75']:.4f}")
    return coco


def speed_task(fwd, loader, device: torch.device) -> dict:
    """Forward + decode ms per image on the first batch: 20 runs after 3,
    synchronised."""
    batch = next(iter(loader))
    rgb = torch.from_numpy(batch["rgb"]).to(device)
    ir = torch.from_numpy(batch["ir"]).to(device) if "ir" in batch else rgb

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(3):
        fwd(rgb, ir)
    sync()
    n = 20
    t0 = time.perf_counter()
    for _ in range(n):
        fwd(rgb, ir)
    sync()
    dt = (time.perf_counter() - t0) / n / rgb.shape[0] * 1000
    logger.info(f"forward+decode: {dt:.2f} ms/image @ bs{rgb.shape[0]}")
    return {"ms_per_image": dt}


def main(argv=None) -> int:
    from ..utils.general import device_from_arg

    logging.basicConfig(format="%(message)s", level=logging.INFO)
    args = parse_args(argv)
    try:
        device_from_arg(args.device)
    except RuntimeError as e:
        print(f"test_cli: {e}", file=sys.stderr)
        return 1
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
