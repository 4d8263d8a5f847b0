"""Evaluator: mAP@{.5,.75,.5:.95} and P/R over a validation loader.

Counterpart of multispectral_object_detection_tpu/train/evaluator.py, the
same protocol line for line: conf 0.001, NMS IoU 0.6, multi-label NMS with
up to 30000 candidates (on the device), predictions rescaled to native
image pixels, greedy TP matching at 10 IoU thresholds and the
``summarize_stats`` summary (host numpy), the log-average miss rate when
nc = 1, and with a ``loss_fn`` the mean box/obj/cls loss over the batches
(summed on the device, read once at the end).

Data-parallel (``shard``, a parallel/mesh.EvalShard): every rank reads the
whole batch, runs its rows of it (padded to the batch size) through the
forward and NMS, and the detections (and, for the loss, the raw outputs)
are gathered in batch order; rank 0 matches and summarises, and every
rank returns its result.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import numpy as np
import torch

from ..ops.nms import batched_nms
from ..utils.general import rescale_to_native
from ..utils.metrics import (IOU_THRESHOLDS, log_average_miss_rate,
                             match_predictions, summarize_stats)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate(forward: Callable, loader, nc: int, *, device,
             conf_thres: float = 0.001, iou_thres: float = 0.6,
             single_cls: bool = False, max_det: int = 300,
             top_k: int = 30000, hybrid: bool = False,
             per_image: Callable = None,
             confusion=None, curves: bool = False,
             loss_fn: Callable = None, shard=None) -> Dict[str, object]:
    """Run the eval protocol; returns the ``summarize_stats`` dict plus
    ``seen``, ``lamr`` (nc = 1) and the per-image times ``t_infer_ms``
    (upload + forward + decode), ``t_nms_ms`` and ``t_match_ms`` (host
    matching), and the NMS load: ``nms_candidates`` (candidates past the
    confidence gate per image) and ``nms_iterations`` (suppression steps
    per batch).

    forward(rgb, ir): uint8 (B, H, W, 3) tensors on ``device`` -> (decoded
        (B, N, 5+nc) detections, anything).
    hybrid: inject the ground truth as unit-confidence NMS candidates
        (``--save-hybrid``).
    per_image(idx, native_boxes, scores, classes, native_hw): called per
        image with the NMS output in native pixels; ``idx`` is the image's
        dataset position, ``batch["index"]`` (batches without it are taken
        to be in dataset order).
    confusion: a metrics.ConfusionMatrix accumulated over all images.
    curves: add ``curves``, the PR/P/R/F1 curves (``summarize_stats``).
    loss_fn: train/loss.DetectionLoss on the forward's raw outputs; adds
        ``val_loss`` [box, obj, cls], the mean over batches.
    shard: parallel/mesh.EvalShard of a data-parallel eval."""
    device = torch.device(device)
    stats = []
    t_infer = t_nms = t_match = 0.0
    seen = 0
    nms_stats = {"candidates": 0, "iterations": 0}
    loss_sum, n_loss = None, 0
    for batch in loader:
        rgb_np = batch["rgb"]
        B, H, W = rgb_np.shape[:3]
        t0 = time.perf_counter()
        rgb = torch.from_numpy(rgb_np).to(device)
        ir = torch.from_numpy(batch["ir"]).to(device) if "ir" in batch \
            else rgb
        if shard is not None:
            rgb, ir = shard.rows(rgb), shard.rows(ir)
        dets_flat, feats = forward(rgb, ir)
        if shard is not None and loss_fn is not None:
            feats = [shard.gather(f, B) for f in feats]
        _sync(device)
        t1 = time.perf_counter()
        targets, tmask = batch["targets"], batch["tmask"]
        if loss_fn is not None:
            with torch.inference_mode():
                _, comps = loss_fn(feats, torch.from_numpy(targets).to(
                    device), torch.from_numpy(tmask).to(device))
                part = torch.stack([comps["box"], comps["obj"],
                                    comps["cls"]])
                loss_sum = part if loss_sum is None else loss_sum + part
            n_loss += 1
        labels = lmask = None
        if hybrid:
            # the collate layout: per-image blocks of max_labels rows
            tg = targets.reshape(B, -1, 6)
            xywh_px = tg[..., 2:6] * np.array([W, H, W, H], np.float32)
            labels = torch.from_numpy(np.concatenate([tg[..., 1:2], xywh_px],
                                                     -1)).to(device)
            lmask = torch.from_numpy(tmask.reshape(B, -1)).to(device)
            if shard is not None:
                labels, lmask = shard.rows(labels), shard.rows(lmask)
        det = batched_nms(dets_flat, conf_thres=conf_thres,
                          iou_thres=iou_thres, multi_label=not single_cls,
                          agnostic=single_cls, max_det=max_det, top_k=top_k,
                          labels=labels, labels_mask=lmask, stats=nms_stats)
        if shard is not None:
            det = [shard.gather(t, B) for t in det]
        boxes, scores, classes, valid = (t.cpu().numpy() for t in det)
        index = batch.get("index")
        t2 = time.perf_counter()
        t_infer += t1 - t0
        t_nms += t2 - t1
        if shard is not None and not shard.mesh.is_main:
            seen += B
            continue  # rank 0 matches

        for si in range(B):
            seen += 1
            v = valid[si]
            pb, ps, pc = boxes[si][v], scores[si][v], classes[si][v]
            if single_cls:
                pc = np.zeros_like(pc)
            sel = (targets[:, 0] == si) & (tmask > 0)
            tcls = targets[sel, 1]
            txywh = targets[sel, 2:6] * np.array([W, H, W, H])
            tb = np.stack([txywh[:, 0] - txywh[:, 2] / 2,
                           txywh[:, 1] - txywh[:, 3] / 2,
                           txywh[:, 0] + txywh[:, 2] / 2,
                           txywh[:, 1] + txywh[:, 3] / 2], 1) \
                if len(txywh) else np.zeros((0, 4))
            native_hw, ratio_pad = batch["shapes"][si]
            pb_n = rescale_to_native(pb, (H, W), native_hw, ratio_pad) \
                if len(pb) else pb
            tb_n = rescale_to_native(tb, (H, W), native_hw, ratio_pad) \
                if len(tb) else tb
            correct = match_predictions(pb_n, pc.astype(float), tb_n,
                                        tcls.astype(float), IOU_THRESHOLDS)
            stats.append((correct, ps, pc.astype(float), list(tcls)))
            if confusion is not None:
                confusion.process_batch(pb_n, ps, pc.astype(float), tb_n,
                                        tcls.astype(float))
            if per_image is not None:
                per_image(seen - 1 if index is None else int(index[si]),
                          pb_n, ps, pc, native_hw)
        t_match += time.perf_counter() - t2

    t3 = time.perf_counter()
    out = summarize_stats(stats, nc, curves=curves)
    if nc == 1 and stats:
        tp50 = np.concatenate([s[0][:, 0] for s in stats])
        conf = np.concatenate([s[1] for s in stats])
        n_gt = sum(len(s[3]) for s in stats)
        out["lamr"] = log_average_miss_rate(tp50, conf, seen, n_gt)
    t_match += time.perf_counter() - t3
    per = max(seen, 1)
    out["seen"] = seen
    out["t_infer_ms"] = 1000.0 * t_infer / per
    out["t_nms_ms"] = 1000.0 * t_nms / per
    out["t_match_ms"] = 1000.0 * t_match / per
    out["nms_candidates"] = int(nms_stats["candidates"]) / per
    out["nms_iterations"] = nms_stats["iterations"] / max(len(loader), 1)
    if n_loss:
        out["val_loss"] = (loss_sum / n_loss).tolist()
    if shard is not None:  # rank 0's metrics on every rank
        box = [out]
        torch.distributed.broadcast_object_list(box, src=0)
        out = box[0]
    return out
