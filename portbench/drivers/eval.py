"""The eval mix: ``train/evaluator.evaluate`` over an in-memory loader,
pass after pass, at the eval protocol (conf 0.001, IoU 0.6, max_det 300,
top_k 30000).

Set-up draws the configuration's weights on the card from the seed, has
``hub.create`` fold, cast and place the model, and makes the loader:
labelled scenes of LLVIP's frame letterboxed into the rect canvas that
the test CLI gives it at the configuration's size (1280 x 1024 into
640 x 512: gain 0.5, no padding), as host uint8 batches with the
collated targets, each image's native shape and letterbox. One pass
warms every shape. The window runs whole passes until it has lasted
``--seconds``.

Correctness, after the window, over the window's first pass: the raw head
outputs of sampled batches against the fp32 reference (``head_gap``);
the reference's decode, NMS and rescaling run on the program's own head
outputs of every batch against what the evaluator handed ``per_image``
(``nms_mismatch``); and the reference's matching and summary of those
detections against the evaluator's summary (``summary_gap``, the largest
difference of mp, mr, mAP@0.5, mAP@0.75 and mAP@0.5:0.95).
"""

from __future__ import annotations

import gc
import random
import time

import numpy as np
import torch

from portbench import harness
from portbench.drivers.serve import head_gap, ref_heads, reference
from portbench.reference.evaluate import match, summary, to_native
from portbench.reference.model import decode, fp8_round
from portbench.reference.nms import nms_image
from portbench.scenes import letterbox_hw, scene_pool
from portbench.seeds import derive
from portbench.weights import draw_state_dict
from portbench.work import flops_per_pair

BOX_TOL_PX = 2e-3   # native pixels (canvas 1e-3 / gain 0.5)
SCORE_TOL = 1e-5


def loader(job: harness.Job):
    """The batches, as the eval data path collates them."""
    tr, cfg = job.traffic, job.cfg
    hw = tuple(tr["canvas_hw"])
    frame = tuple(cfg["frame_hw"])
    (h, w), (top, left) = letterbox_hw(frame, hw)
    gain = h / frame[0]
    m = tr["max_labels"]
    out, index = [], 0
    for rgb, ir, labels in scene_pool(job.seed, tr["images"] // tr["batch"],
                                      tr["batch"], hw, frame, cfg["nc"],
                                      tr["max_objects"], job.device):
        b = len(rgb)
        targets = np.zeros((b * m, 6), np.float32)
        tmask = np.zeros((b * m,), np.float32)
        for i, rows in enumerate(labels):
            targets[i * m:i * m + len(rows), 0] = i
            targets[i * m:i * m + len(rows), 1:] = rows[:m]
            tmask[i * m:i * m + len(rows)] = 1
        out.append({"rgb": rgb, "ir": ir, "targets": targets, "tmask": tmask,
                    "shapes": [(frame, ((gain, gain), (left, top)))] * b,
                    "index": np.arange(index, index + b)})
        index += b
    return out


def build(job: harness.Job):
    from multispectral_object_detection_tpu_torch.hub import create

    sd = draw_state_dict(job.cfg, job.seed, job.device)
    model = create(job.model_cfg, state_dict=sd,
                   dtype=getattr(torch, job.cfg["dtype"]), device=job.device)
    del sd
    return model


def run(job: harness.Job) -> harness.Outcome:
    from multispectral_object_detection_tpu_torch.train.eval_forward import (
        make_eval_forward)
    from multispectral_object_detection_tpu_torch.train.evaluator import (
        evaluate)

    tr, dev = job.traffic, job.device
    data = loader(job)
    model = build(job)
    fwd = make_eval_forward(model)
    capture = {"on": False, "raw": []}

    def forward(rgb, ir):
        dets, feats = fwd(rgb, ir)
        if capture["on"]:
            capture["raw"].append(feats)
        return dets, feats

    kept = {}

    def per_image(idx, boxes, scores, classes, native_hw):
        if capture["on"]:
            kept[idx] = (boxes, scores, classes)

    def one_pass(batches=data):
        return evaluate(forward, batches, job.cfg["nc"], device=dev,
                        conf_thres=tr["conf"], iou_thres=tr["iou"],
                        max_det=tr["max_det"], top_k=tr["top_k"],
                        per_image=per_image)

    one_pass()  # every shape once
    harness.sync(dev)
    setup_s = time.perf_counter() - job.t0

    passes = []
    t_start = time.perf_counter()
    while True:
        capture["on"] = not passes
        passes.append(one_pass())
        capture["on"] = False
        if time.perf_counter() - t_start >= job.seconds:
            break
    window_s = time.perf_counter() - t_start
    peak = harness.peak_bytes(dev)
    images = len(passes) * tr["images"]
    trace = None
    if job.trace:  # a call: evaluate over the first trace_batches batches
        k = tr["trace_batches"]
        trace = harness.profile_calls(lambda: one_pass(data[:k]), 1, dev,
                                      gap_calls=1)
    first, raw = passes[0], capture["raw"]
    del model, fwd
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()

    checks, control = check(job, data, raw, kept, first)
    device = harness.card_info(dev)
    device["memory_peak_bytes"] = peak
    counters = {"passes": len(passes), "window_s": window_s,
                "nms_candidates_per_image": first["nms_candidates"],
                "nms_iterations_per_batch": first["nms_iterations"],
                "map50": first["map50"]}
    if job.trace:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
        hw = tuple(tr["canvas_hw"])
        ctx = {"trace": trace, "cfg": job.cfg, "traffic": tr,
               "device": device, "pairs_per_s": images / window_s,
               "wall_per_call_s": window_s * tr["trace_batches"]
               / (len(passes) * len(data)),
               "evaluator": {k: float(np.mean([p[k] for p in passes]))
                             for k in ("t_infer_ms", "t_nms_ms",
                                       "t_match_ms")},
               "flops_per_pair": flops_per_pair(job.model_cfg, hw)}
        metrics = harness.read_per_layer(job, ctx)
    else:
        metrics = {"pairs_per_s": {"value": images / window_s,
                                   "unit": "pairs/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    harness.log(f"eval: {len(passes)} passes of {tr['images']} pairs in "
                f"{window_s:.3f} s; {first['nms_candidates']:.0f} NMS "
                f"candidates per image; set-up {setup_s:.3f} s")
    return harness.Outcome(
        attempted=images, failed=0, metrics=metrics, checks=checks,
        device=device, breakdown=harness.breakdown(trace) if trace else None,
        counters=counters, control=control)


def check(job: harness.Job, data, raw, kept, first) -> dict:
    tr, lim = job.traffic, job.limits
    ref = reference(job)
    rng = random.Random(derive(job.seed, "sample"))
    sample = rng.sample(range(len(data)), tr["sample_batches"])
    gaps = [head_gap(raw[k], ref_heads(ref, data[k]["rgb"], data[k]["ir"],
                                       tr["ref_block"], job.device))
            for k in sample]
    bad, stats = 0, []
    for batch, feats in zip(data, raw):
        pred = decode([f.float() for f in feats], ref.anchors,
                      ref.strides).cpu().numpy()
        H, W = batch["rgb"].shape[1:3]
        for i, idx in enumerate(batch["index"]):
            b, s, c = nms_image(pred[i], tr["conf"], tr["iou"], tr["max_det"],
                                tr["top_k"], True)
            native, ((gain, _), pad) = batch["shapes"][i]
            b = to_native(b, gain, pad, native)
            pb, ps, pc = kept.get(int(idx), (np.zeros((0, 4)),) * 3)
            m = min(len(b), len(pb))
            bad += abs(len(b) - len(pb)) + int((
                (np.abs(pb[:m] - b[:m]).max(1, initial=0) > BOX_TOL_PX)
                | (np.abs(ps[:m] - s[:m]) > SCORE_TOL)
                | (pc[:m] != c[:m])).sum())
            sel = (batch["targets"][:, 0] == i) & (batch["tmask"] > 0)
            t = batch["targets"][sel]
            tb = np.stack([t[:, 2] - t[:, 4] / 2, t[:, 3] - t[:, 5] / 2,
                           t[:, 2] + t[:, 4] / 2, t[:, 3] + t[:, 5] / 2],
                          1) * np.array([W, H, W, H]) if len(t) else \
                np.zeros((0, 4))
            tb = to_native(tb, gain, pad, native)
            stats.append((match(b, c.astype(float), tb, t[:, 1]), s,
                          c.astype(float), list(t[:, 1])))
    want = summary(stats)
    sgap = max(abs(float(first[k]) - want[k]) for k in want)
    control = {}
    if job.control:  # the reference in fp8 in the program's place
        low = reference(job, fp8_round)
        control["head_gap"] = max(
            head_gap(ref_heads(low, data[k]["rgb"], data[k]["ir"],
                               tr["ref_block"], job.device),
                     ref_heads(ref, data[k]["rgb"], data[k]["ir"],
                               tr["ref_block"], job.device))
            for k in sample)
        del low
    del ref
    return {"head_gap": (max(gaps), lim["head_gap"]),
            "nms_mismatch": (bad, lim["nms_mismatch"]),
            "summary_gap": (sgap, lim["summary_gap"])}, control
