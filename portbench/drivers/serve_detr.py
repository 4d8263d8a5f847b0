"""The serving mix of a set-prediction detector (Deformable DETR): one
client in a closed loop over ``hub.Detector.infer`` on single-stream
batches.

Set-up asks the program for the configuration by name (a program without
it stops here, before anything is drawn), draws the weights on the card
from the seed (the official layout, frozen BatchNorm unfolded), builds
``hub.Detector`` from them (the program renames, folds, casts and places
the model), makes a pool of distinct scene batches and hands the model
one stream of each, the thermal frames, as host uint8 arrays, each batch
once. The window then sends the pool's batches in a seeded order, one
call at a time: the clock of a call runs from handing the host batch to
``infer`` until the ``Detections`` (the top k of every image) are on the
host.

Correctness, after the window: a sample of the window's calls drawn from
the seed (reservoir sampling) keeps the program's raw outputs (logits and
boxes, a forward hook) and its fetched detections. The fp32 reference
recomputes logits and boxes from the same batch and weights
(``out_gap``: the worse of the two of max |program - reference| over
max |reference|), and the reference's top-k selection, run on the
program's own outputs, must give the program's detections
(``select_mismatch``: detections that differ).

The traced run reads, beside the harness's device trace, the device time
of the kernels launched under the program's ``msda`` spans, from a trace
that records the host's operators too (``span_device_ms``).
"""

from __future__ import annotations

import gc
import random
import time

import numpy as np
import torch

from portbench import harness
from portbench.drivers.serve import BOX_TOL_PX, MISSING, SCORE_TOL
from portbench.reference import deformable_detr as ref_detr
from portbench.reference.deformable_detr_weights import draw_state_dict
from portbench.reference.model import fp8_round, strict_fp32
from portbench.scenes import scene_pool
from portbench.seeds import derive
from portbench.work_detr import flops_per_image

SPANS = ("msda",)  # program spans whose kernels the traced run times


def build(job: harness.Job):
    """The program's detector from the seeded state dict."""
    from multispectral_object_detection_tpu_torch.hub import Detector
    from multispectral_object_detection_tpu_torch.models.configs import \
        get_config

    cfg = job.cfg
    get_config(cfg["program_cfg"])  # raises where the program lacks it
    sd = draw_state_dict(cfg, job.seed, job.device)
    det = Detector(cfg["program_cfg"], state_dict=sd, img_size=cfg["canvas"],
                   conf=job.traffic["conf"],
                   dtype=getattr(torch, cfg["dtype"]), device=job.device)
    del sd
    return det


def msda_counts():
    """The program's ``msda.`` counters (calls, samples), or None."""
    try:
        from multispectral_object_detection_tpu_torch.utils import tracing
    except ImportError:
        return None
    c = tracing.counters("msda.")
    return c.get("msda.calls", 0), c.get("msda.samples", 0)


def span_device_ms(fn, calls: int, device, names=SPANS) -> dict:
    """Device ms per call of every kernel launched under each named span
    (the ``record_function`` range a program span opens while the
    profiler records), over ``calls`` calls of ``fn`` traced with the
    host's operators; a name with no such range is left out."""
    from torch.profiler import ProfilerActivity

    prof, _ = harness._traced(fn, calls, device, [ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA])
    out = {}
    for e in prof.events():
        if e.name in names and e.device_type.name == "CPU":
            out[e.name] = out.get(e.name, 0.0) + e.device_time_total / 1e3
    return {k: v / calls for k, v in out.items() if v > 0}


def run(job: harness.Job) -> harness.Outcome:
    tr, cfg = job.traffic, job.cfg
    dev = job.device
    det = build(job)
    canvas = (cfg["canvas"], cfg["canvas"])
    pool = scene_pool(job.seed, tr["pool"], tr["batch"], canvas,
                      cfg["frame_hw"], tr["scene_classes"], tr["max_objects"],
                      dev)
    stream = 1 if tr["input"] == "ir" else 0
    captured = {}
    hook = det.model.register_forward_hook(
        lambda m, i, o: captured.__setitem__("raw", o))

    def call(k):
        return [t.cpu() for t in det.infer(pool[k][stream])]

    for k in range(len(pool)):  # every batch once: builds, algorithms
        call(k)
    harness.sync(dev)
    setup_s = time.perf_counter() - job.t0

    rng = random.Random(derive(job.seed, "order"))
    sampler = random.Random(derive(job.seed, "sample"))
    kept, lat, ends = [], [], []  # reservoir: (call, batch, raw, dets)
    n = n_valid = 0
    counts0 = msda_counts()
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
    counts1 = msda_counts()
    captured.clear()
    peak = harness.peak_bytes(dev)
    pairs_per_s = n * tr["batch"] / window_s
    trace = span_ms = None
    if job.trace:
        def one():
            call(rng.randrange(len(pool)))

        trace = harness.profile_calls(one, tr["trace_calls"], dev)
        span_ms = span_device_ms(one, tr["span_calls"], dev)
    hook.remove()
    del det
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()

    checks, control = check(job, pool, stream, kept)
    device = harness.card_info(dev)
    device["memory_peak_bytes"] = peak
    counters = {"calls": n, "window_s": window_s,
                "detections_per_image": n_valid / (n * tr["batch"]),
                "sampled_calls": sorted(c for c, *_ in kept),
                "quarter_pairs_per_s": harness.quarter_rates(
                    ends, t_start, t_start + window_s, tr["batch"])}
    if counts0 is not None:
        counters["msda_calls_per_call"] = (counts1[0] - counts0[0]) / n
        counters["msda_samples_per_call"] = (counts1[1] - counts0[1]) / n
    if job.trace:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
        ctx = {"trace": trace, "cfg": cfg, "traffic": tr, "device": device,
               "pairs_per_s": pairs_per_s, "batch": tr["batch"],
               "wall_per_call_s": window_s / n, "hw": canvas,
               "flops_per_pair": flops_per_image(cfg, canvas),
               "span_ms": span_ms}
        metrics = harness.read_per_layer(job, ctx)
    else:
        metrics = {"pairs_per_s": {"value": pairs_per_s, "unit": "pairs/s"},
                   "latency_p95_ms": {"value": 1e3 * float(np.quantile(
                       lat, 0.95, method="linear")), "unit": "ms"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    harness.log(f"serve_detr: {n} calls of {tr['batch']} images in "
                f"{window_s:.3f} s; {counters['detections_per_image']:.2f} "
                f"detections per image; set-up {setup_s:.3f} s")
    return harness.Outcome(
        attempted=n, failed=0, metrics=metrics, checks=checks, device=device,
        breakdown=harness.breakdown(trace) if trace else None,
        counters=counters, control=control)


def reference(job: harness.Job, rounding=None) -> ref_detr.DeformableDETR:
    """The reference on the run's device from a fresh draw of the seed's
    weights (nothing the program made)."""
    sd = draw_state_dict(job.cfg, job.seed, job.device)
    with torch.device("meta"):
        ref = ref_detr.DeformableDETR(job.cfg, rounding)
    ref.load_state_dict(sd, assign=True)
    return ref.eval()


def ref_outputs(ref, imgs: np.ndarray, block: int, device):
    """The reference's (logits, boxes) for a host uint8 batch, fp32, in
    blocks of ``block`` images."""
    outs = []
    for a in range(0, len(imgs), block):
        x = torch.from_numpy(imgs[a:a + block]).to(device).permute(
            0, 3, 1, 2).float() / 255.0
        with torch.no_grad(), strict_fp32():
            outs.append(ref(x))
    return [torch.cat(s) for s in zip(*outs)]


def out_gap(prog, ref) -> float:
    """The worse of logits and boxes: max |program - reference| / max
    |reference|."""
    if len(prog) != len(ref) or any(p.shape != r.shape
                                    for p, r in zip(prog, ref)):
        return MISSING
    return max(float((p.float() - r).abs().max() / r.abs().max())
               for p, r in zip(prog, ref))


def select_mismatch(raw, dets, top_k: int, conf: float, canvas) -> int:
    """Detections that differ between the program's and the reference's
    top-k selection run on the program's own (logits, boxes): a count of
    kept detections per image that differ, plus any slot whose class,
    score or box disagrees."""
    boxes, scores, classes, valid = (t.numpy() for t in dets)
    bad = 0
    for i, (rb, rs, rc) in enumerate(ref_detr.select(*raw, top_k, conf,
                                                     canvas)):
        v = valid[i]
        pb, ps, pc = boxes[i][v], scores[i][v], classes[i][v]
        m = min(len(rb), len(pb))
        bad += abs(len(rb) - len(pb))
        bad += int(((np.abs(pb[:m] - rb[:m]).max(1, initial=0) > BOX_TOL_PX)
                    | (np.abs(ps[:m] - rs[:m]) > SCORE_TOL)
                    | (pc[:m] != rc[:m])).sum())
    return bad


def check(job: harness.Job, pool, stream: int, kept):
    """The compared numbers {name: (value, limit)} over the sampled calls,
    and with ``job.control`` the control's reading of ``out_gap``: the
    reference in fp8 put in the program's place."""
    tr, lim, cfg = job.traffic, job.limits, job.cfg
    canvas = (cfg["canvas"], cfg["canvas"])
    ref = reference(job)
    gaps, bad, refs = [], 0, {}
    for _, k, raw, dets in kept:
        if k not in refs:
            refs[k] = ref_outputs(ref, pool[k][stream], tr["ref_block"],
                                  job.device)
        gaps.append(out_gap(raw, refs[k]))
        bad += select_mismatch(raw, dets, cfg["top_k"], tr["conf"], canvas)
    del ref
    control = {}
    if job.control:
        low = reference(job, fp8_round)
        control["out_gap"] = max(
            out_gap(ref_outputs(low, pool[k][stream], tr["ref_block"],
                                job.device), refs[k]) for k in refs)
        del low
    del refs
    return ({"out_gap": (max(gaps), lim["out_gap"]),
             "select_mismatch": (bad, lim["select_mismatch"])}, control)
