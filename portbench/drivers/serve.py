"""The serving mix: one client in a closed loop over ``hub.Detector.infer``.

Set-up draws the configuration's weights on the card from the seed (the
reference layout, BatchNorm unfolded), builds ``hub.Detector`` from them
(the program folds, casts and places the model), makes a pool of distinct
scene batches as host uint8 arrays, and calls each once. The window then
sends the pool's batches in a seeded order, one call at a time: the clock
of a call runs from handing the host batches to ``infer`` until the
``Detections`` are on the host, as ``Detector.__call__`` fetches them.

Correctness, after the window: a sample of the window's calls drawn from
the seed (reservoir sampling, so the whole window is drawn from) keeps the
program's three raw head outputs (a forward hook) and its fetched
detections. The fp32 reference recomputes the head outputs from the same
batch and weights (``head_gap``: the largest |program - reference| over
the largest |reference|, worst scale), and the reference's decode and NMS,
run on the program's own head outputs, must give the program's detections
(``nms_mismatch``: detections that differ; the stage is followed from the
program's state, and its start is the head comparison).
"""

from __future__ import annotations

import gc
import random
import time

import numpy as np
import torch

from portbench import harness
from portbench.reference.model import ReferenceModel, decode, fp8_round, \
    strict_fp32
from portbench.reference.nms import nms_image
from portbench.scenes import scene_pool
from portbench.seeds import derive
from portbench.weights import draw_state_dict
from portbench.work import flops_per_pair

BOX_TOL_PX = 1e-3   # one detection equals another within these
SCORE_TOL = 1e-5


def build(job: harness.Job):
    """The program's detector from the seeded state dict."""
    from multispectral_object_detection_tpu_torch.hub import Detector

    tr, cfg = job.traffic, job.cfg
    sd = draw_state_dict(cfg, job.seed, job.device)
    det = Detector(cfg=job.model_cfg, state_dict=sd, img_size=cfg["canvas"],
                   conf=tr["conf"], iou=tr["iou"],
                   dtype=getattr(torch, cfg["dtype"]), device=job.device)
    del sd
    return det


def run(job: harness.Job) -> harness.Outcome:
    tr, cfg = job.traffic, job.cfg
    dev = job.device
    det = build(job)
    canvas = (cfg["canvas"], cfg["canvas"])
    pool = scene_pool(job.seed, tr["pool"], tr["batch"], canvas,
                      cfg["frame_hw"], cfg["nc"], tr["max_objects"], dev)
    captured = {}
    hook = det.model.register_forward_hook(
        lambda m, i, o: captured.__setitem__("raw", o))

    def call(k):
        rgb, ir, _ = pool[k]
        return [t.cpu() for t in det.infer(rgb, ir)]

    for k in range(len(pool)):  # every batch once: builds, algorithms
        call(k)
    harness.sync(dev)
    setup_s = time.perf_counter() - job.t0

    rng = random.Random(derive(job.seed, "order"))
    sampler = random.Random(derive(job.seed, "sample"))
    kept, lat, ends = [], [], []  # reservoir: (call, batch, raw, dets)
    n = n_valid = 0
    t_start = time.perf_counter()
    while True:
        k = rng.randrange(len(pool))
        t = time.perf_counter()
        dets = call(k)
        lat.append(time.perf_counter() - t)
        ends.append(t + lat[-1])
        n_valid += int(dets[3].sum())
        item = (n, k, captured["raw"], dets)
        if len(kept) < tr["sample_calls"]:
            kept.append(item)
        else:
            j = sampler.randrange(n + 1)
            if j < len(kept):
                kept[j] = item
        n += 1
        if time.perf_counter() - t_start >= job.seconds:
            break
    window_s = time.perf_counter() - t_start
    captured.clear()
    peak = harness.peak_bytes(dev)
    pairs_per_s = n * tr["batch"] / window_s
    trace = None
    if job.trace:
        trace = harness.profile_calls(
            lambda: call(rng.randrange(len(pool))), tr["trace_calls"], dev)
    hook.remove()
    del det
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()

    checks, control = check(job, pool, kept)
    device = harness.card_info(dev)
    device["memory_peak_bytes"] = peak
    counters = {"calls": n, "window_s": window_s,
                "detections_per_image": n_valid / (n * tr["batch"]),
                "sampled_calls": sorted(c for c, *_ in kept),
                "quarter_pairs_per_s": harness.quarter_rates(
                    ends, t_start, t_start + window_s, tr["batch"])}
    if job.trace:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
        ctx = {"trace": trace, "cfg": cfg, "traffic": tr, "device": device,
               "pairs_per_s": pairs_per_s, "batch": tr["batch"],
               "wall_per_call_s": window_s / n,
               "hw": canvas, "flops_per_pair": flops_per_pair(
                   job.model_cfg, canvas)}
        metrics = harness.read_per_layer(job, ctx)
    else:
        metrics = {"pairs_per_s": {"value": pairs_per_s, "unit": "pairs/s"},
                   "latency_p95_ms": {"value": 1e3 * float(np.quantile(
                       lat, 0.95, method="linear")), "unit": "ms"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    harness.log(f"serve: {n} calls of {tr['batch']} pairs in {window_s:.3f} s;"
                f" {counters['detections_per_image']:.2f} detections per "
                f"image; set-up {setup_s:.3f} s")
    return harness.Outcome(
        attempted=n, failed=0, metrics=metrics, checks=checks, device=device,
        breakdown=harness.breakdown(trace) if trace else None,
        counters=counters, control=control)


def reference(job: harness.Job, rounding=None) -> ReferenceModel:
    """The reference on the run's device from a fresh draw of the seed's
    weights (nothing the program made)."""
    sd = draw_state_dict(job.cfg, job.seed, job.device)
    with torch.device("meta"):
        ref = ReferenceModel(job.model_cfg, rounding)
    ref.load_state_dict(sd, assign=True)
    return ref.eval()


def ref_heads(ref, rgb: np.ndarray, ir: np.ndarray, block: int, device):
    """The reference's raw head outputs for host uint8 batches, fp32, in
    blocks of ``block`` images."""
    outs = []
    for a in range(0, len(rgb), block):
        x, x2 = (torch.from_numpy(t[a:a + block]).to(device).permute(
            0, 3, 1, 2).float() / 255.0 for t in (rgb, ir))
        with torch.no_grad(), strict_fp32():
            outs.append(ref(x, x2))
    return [torch.cat(s) for s in zip(*outs)]


MISSING = 1e9  # the gap of an output that is missing or of another shape


def head_gap(prog, ref) -> float:
    """Worst scale's max |program - reference| / max |reference|."""
    if len(prog) != len(ref) or any(p.shape != r.shape
                                    for p, r in zip(prog, ref)):
        return MISSING
    return max(float((p.float() - r).abs().max() / r.abs().max())
               for p, r in zip(prog, ref))


def nms_mismatch(ref, raw, dets, tr) -> int:
    """Detections that differ between the program's and those of the
    reference's decode and NMS run on the program's head outputs: a count
    of kept boxes per image that differ, plus any slot whose class, score
    or box disagrees."""
    boxes, scores, classes, valid = (t.numpy() for t in dets)
    pred = decode(raw, ref.anchors, ref.strides).cpu().numpy()
    bad = 0
    for i in range(len(pred)):
        rb, rs, rc = nms_image(pred[i], tr["conf"], tr["iou"], tr["max_det"],
                               tr["top_k"], tr.get("multi_label", False))
        v = valid[i]
        pb, ps, pc = boxes[i][v], scores[i][v], classes[i][v]
        m = min(len(rb), len(pb))
        bad += abs(len(rb) - len(pb))
        bad += int(((np.abs(pb[:m] - rb[:m]).max(1, initial=0) > BOX_TOL_PX)
                    | (np.abs(ps[:m] - rs[:m]) > SCORE_TOL)
                    | (pc[:m] != rc[:m])).sum())
    return bad


def check(job: harness.Job, pool, kept):
    """The compared numbers {name: (value, limit)} over the sampled calls,
    and with ``job.control`` the control's reading of ``head_gap``: the
    reference in fp8 put in the program's place."""
    tr, lim = job.traffic, job.limits
    ref = reference(job)
    gaps, bad, refs = [], 0, {}
    for _, k, raw, dets in kept:
        rgb, ir, _ = pool[k]
        if k not in refs:
            refs[k] = ref_heads(ref, rgb, ir, tr["ref_block"], job.device)
        gaps.append(head_gap(raw, refs[k]))
        bad += nms_mismatch(ref, [r.float() for r in raw], dets, tr)
    control = {}
    if job.control:
        low = reference(job, fp8_round)
        control["head_gap"] = max(
            head_gap(ref_heads(low, *pool[k][:2], tr["ref_block"], job.device),
                     refs[k]) for k in refs)
        del low
    del ref, refs
    return ({"head_gap": (max(gaps), lim["head_gap"]),
             "nms_mismatch": (bad, lim["nms_mismatch"])}, control)
