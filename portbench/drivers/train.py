"""The training mix: ``train/trainer.make_train_step`` as ``bench_train``
builds it, on a pool of seeded batches uploaded from the host each step.

Set-up draws the configuration's weights on the card from the seed and
loads them into the program's unfused model (bf16 compute, fp32
parameters), builds the recipe's SGD (scratch hyps, 100 steps per epoch,
300 epochs, accumulation to a nominal 64), the train state with its EMA
and the step, and drives that same step through its first three steps on
three different batches of the pool, with dropout keyed by seeds drawn
from the run's seed. The window then runs steps back to back, the pool's
batches in turn, with no synchronisation inside the loop, and ends in
``torch.cuda.synchronize()``; the peak memory is read over the window.

Correctness, after the window, with the program freed: the fp32 reference
(``reference/train_step.py``) takes the same three steps from a fresh draw
of the same weights on the same batches with the same dropout masks. Per
step the loss; per leaf the norm of the first gradient as the optimizer
got it (its momentum buffer after one step), the norm of the parameters'
change over the three steps and the norm of the EMA's change; each leaf's
gap between the program's norm and the reference's, over the larger of
the reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of the changes.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import harness
from portbench.drivers.serve import head_gap
from portbench.reference.model import ReferenceModel, strict_fp32
from portbench.reference.train_step import (DropoutKeys, Hyp, Sgd,
                                            ema_update, yolo_loss)
from portbench.scenes import scene_pool
from portbench.seeds import derive
from portbench.weights import draw_state_dict
from portbench.work import train_flops_per_step

CHECKED_STEPS = 3
GRAD_FLOOR = 1e-3  # of the median leaf's first gradient: round-off only
READINGS = ("head_gap", "ema_head_gap", "loss_gap", "grad_gap",
            "change_gap", "ema_gap", "grad_med", "change_med", "ema_med")


def batches(job: harness.Job):
    """The pool: host uint8 batches and their padded targets (rows of
    ``max_labels`` per image [image, class, x, y, w, h], a mask)."""
    tr, cfg = job.traffic, job.cfg
    canvas = (cfg["canvas"], cfg["canvas"])
    out = []
    for rgb, ir, labels in scene_pool(job.seed, tr["pool"], tr["batch"],
                                      canvas, cfg["frame_hw"], cfg["nc"],
                                      tr["max_objects"], job.device):
        m = tr["max_labels"]
        targets = np.zeros((len(rgb) * m, 6), np.float32)
        tmask = np.zeros((len(rgb) * m,), np.float32)
        for b, rows in enumerate(labels):
            targets[b * m:b * m + len(rows), 0] = b
            targets[b * m:b * m + len(rows), 1:] = rows[:m]
            tmask[b * m:b * m + len(rows)] = 1
        out.append((rgb, ir, targets, tmask))
    return out


def step_seed(job: harness.Job, i: int) -> int:
    return derive(job.seed, f"step{i}")


def build(job: harness.Job, sd):
    """The program's train state and step, from the seeded weights."""
    from multispectral_object_detection_tpu_torch.models.detect import (
        anchor_arrays)
    from multispectral_object_detection_tpu_torch.models.model import (
        build_model, load_reference_state_dict)
    from multispectral_object_detection_tpu_torch.train.loss import (
        DetectionLoss, LossHyp)
    from multispectral_object_detection_tpu_torch.train.optim import (
        OptHyp, build_optimizer)
    from multispectral_object_detection_tpu_torch.train.trainer import (
        TrainState, make_train_step)

    tr, nc, bs = job.traffic, job.cfg["nc"], job.traffic["batch"]
    model = build_model(job.model_cfg, dtype=getattr(torch, job.cfg["dtype"]))
    load_reference_state_dict(model, sd)
    model = model.to(job.device).to(memory_format=torch.channels_last)
    spec = model.spec
    loss_fn = DetectionLoss(nc, anchor_arrays(spec.anchors), spec.strides,
                            LossHyp())
    opt = build_optimizer(model, OptHyp(), tr["steps_per_epoch"],
                          tr["epochs"], max(round(64 / bs), 1), bs)
    state = TrainState(model, opt)
    return state, make_train_step(state, loss_fn, remat=tr["remat"])


def leaf_change(now: Dict[str, torch.Tensor], before) -> Dict[str, float]:
    return {k: float((v.detach().float() - before[k].float()).double().norm())
            for k, v in now.items() if k in before}


def run(job: harness.Job) -> harness.Outcome:
    from multispectral_object_detection_tpu_torch.train import trainer

    tr, dev = job.traffic, job.device
    bs = tr["batch"]
    pool = batches(job)
    sd = draw_state_dict(job.cfg, job.seed, dev)
    state, step = build(job, sd)

    def feed(i):
        return [torch.from_numpy(a).to(dev) for a in pool[i % len(pool)]]

    first: List[torch.Tensor] = []
    heads = []  # the first step's raw head outputs
    hook = state.model.register_forward_hook(
        lambda m, i, o: heads.append(tuple(t.detach() for t in o))
        if not heads else None)
    for i in range(CHECKED_STEPS):  # the checked steps, through the window's call
        first.append(step(*feed(i), seed=step_seed(job, i))["total"])
        if i == 0:
            hook.remove()
            m1 = {n: float(m.double().norm()) for n, m in
                  zip(state.opt.names, state.opt.state["m"])}
    # the EMA after the checked steps, through the trainer's eval forward,
    # on the pool's next batch
    _, ema_heads = trainer.make_eval_forward(state)(*feed(CHECKED_STEPS)[:2])
    prog = {"loss": [float(v) for v in first], "grad": m1, "heads": heads[0],
            "ema_heads": tuple(t.clone() for t in ema_heads),
            "change": leaf_change(dict(state.model.named_parameters()), sd),
            "ema": leaf_change(state.ema_model.state_dict(), sd)}
    del sd
    harness.sync(dev)
    setup_s = time.perf_counter() - job.t0

    setup_peak = harness.peak_bytes(dev)
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    n = CHECKED_STEPS
    t_start = time.perf_counter()
    while True:
        step(*feed(n), seed=step_seed(job, n))
        n += 1
        if time.perf_counter() - t_start >= job.seconds:
            break
    host_s = time.perf_counter() - t_start
    harness.sync(dev)
    window_s = time.perf_counter() - t_start
    steps = n - CHECKED_STEPS
    train_peak = harness.peak_bytes(dev)
    trace = None
    if job.trace:
        def one():
            nonlocal n
            step(*feed(n), seed=step_seed(job, n))
            n += 1
        trace = harness.profile_calls(one, tr["trace_steps"], dev,
                                      gap_calls=1)
    peak = max(setup_peak, harness.peak_bytes(dev))
    del state, step
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_steps(job, pool)
    checks = {k: (gap(prog, ref, k), job.limits[k]) for k in job.limits}
    readings = {k: gap(prog, ref, k) for k in READINGS}
    control = {}
    if job.control:
        control = control_readings(job, pool, ref)
        control["look"] = look(prog, ref)
    device = harness.card_info(dev)
    device["memory_peak_bytes"] = peak
    images_per_s = steps * bs / window_s
    counters = {"steps": steps, "window_s": window_s,
                "host_ms_per_step": 1e3 * host_s / steps,
                "losses": prog["loss"], "readings": readings}
    if job.trace:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
        canvas = (job.cfg["canvas"],) * 2
        ctx = {"trace": trace, "cfg": job.cfg, "traffic": tr,
               "device": device, "steps_per_s": steps / window_s,
               "wall_per_call_s": window_s / steps,
               "host_ms_per_step": counters["host_ms_per_step"],
               "train_flops_per_step": train_flops_per_step(
                   job.model_cfg, bs, canvas)}
        metrics = harness.read_per_layer(job, ctx)
    else:
        metrics = {"train_images_per_s": {"value": images_per_s,
                                          "unit": "images/s"},
                   "train_peak_gb": {"value": train_peak / 1e9, "unit": "GB"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    harness.log(f"train: {steps} steps of {bs} in {window_s:.3f} s "
                f"(host {counters['host_ms_per_step']:.1f} ms per step); "
                f"set-up {setup_s:.3f} s")
    return harness.Outcome(
        attempted=steps, failed=0, metrics=metrics, checks=checks,
        device=device, breakdown=harness.breakdown(trace) if trace else None,
        counters=counters, control=control)


def reference_steps(job: harness.Job, pool, rounding=None,
                    rows: int = None) -> dict:
    """The reference's first steps from a fresh draw of the weights: the
    losses, the first gradient's leaf norms (its momentum buffer after one
    step), the leaf norms of the parameters' and the EMA's change. With
    ``rows`` only the first rows of each batch (the half-batch fault)."""
    tr, dev = job.traffic, job.device
    sd = draw_state_dict(job.cfg, job.seed, dev)
    with torch.device("meta"):
        ref = ReferenceModel(job.model_cfg, rounding)
    ref.load_state_dict({k: v.clone() for k, v in sd.items()}, assign=True)
    ref.train()
    opt = Sgd(ref, Hyp(), tr["steps_per_epoch"], tr["epochs"], tr["batch"])
    ema = {k: v.detach().clone() for k, v in ref.state_dict().items()
           if v.is_floating_point()}
    params = list(opt.params.values())
    losses, t = [], 0
    with strict_fp32():
        for i in range(CHECKED_STEPS):
            rgb, ir, targets, tmask = pool[i]
            keep = tmask > 0
            tg = targets[keep]
            if rows is not None:
                rgb, ir = rgb[:rows], ir[:rows]
                tg = tg[tg[:, 0] < rows]
            x, x2 = (torch.from_numpy(a).to(dev).permute(0, 3, 1, 2).float()
                     / 255.0 for a in (rgb, ir))
            ref.ctx.dropout = DropoutKeys(step_seed(job, i))
            feats = ref(x, x2)
            loss, _, _ = yolo_loss(feats, torch.from_numpy(tg).to(dev),
                                   ref.anchors, ref.strides, ref.nc, Hyp())
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = {n: torch.zeros_like(p) if g is None else g
                     for (n, p), g in zip(opt.params.items(), grads)}
            losses.append(float(loss.detach()))
            if i == 0:
                heads = tuple(f.detach() for f in feats)
            if opt.update(grads):
                t += 1
                ema_update(ema, ref, t)
            if i == 0:
                grad = {n: float(b.double().norm()) for n, b in opt.buf.items()}
    with torch.device("meta"):
        ema_model = ReferenceModel(job.model_cfg, rounding)
    ema_model.load_state_dict(ema, assign=True)
    rgb, ir = pool[CHECKED_STEPS][:2]
    x, x2 = (torch.from_numpy(a).to(dev).permute(0, 3, 1, 2).float() / 255.0
             for a in (rgb, ir))
    with torch.no_grad(), strict_fp32():
        ema_heads = ema_model.eval()(x, x2)
    out = {"loss": losses, "grad": grad, "heads": heads,
           "ema_heads": ema_heads,
           "change": leaf_change(dict(ref.named_parameters()), sd),
           "ema": leaf_change(ema, sd)}
    del ref, opt, ema, sd, ema_model
    gc.collect()
    return out


def leaf_gaps(prog: dict, ref: dict, key: str) -> Dict[str, float]:
    """{leaf: |program norm - reference norm| over the larger of the
    reference's norm of the leaf and of the median leaf} for ``key``
    (``grad``, ``change`` or ``ema``); the changes leave out leaves whose
    reference gradient is under GRAD_FLOOR of the median leaf's."""
    r, p, g = ref[key], prog[key], ref["grad"]
    floor = GRAD_FLOOR * float(np.median(list(g.values())))
    leaves = [k for k in r if k in p and (key == "grad" or g.get(k, floor)
                                          >= floor)]
    med = float(np.median([r[k] for k in leaves]))
    return {k: abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in leaves}


def gap(prog: dict, ref: dict, name: str) -> float:
    """The compared number ``name``: the first step's raw head outputs
    (``head_gap``, as the serving cells read them), those of the EMA after
    the checked steps in eval mode on the pool's next batch
    (``ema_head_gap``), the worst step's
    relative loss gap (``loss_gap``), or the worst leaf's gap (``grad_gap``, ``change_gap``,
    ``ema_gap``) or the median leaf's (``grad_med``, ``change_med``,
    ``ema_med``) of ``leaf_gaps``."""
    if name == "loss_gap":
        return max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                       ref["loss"]))
    if name in ("head_gap", "ema_head_gap"):
        key = "heads" if name == "head_gap" else "ema_heads"
        return head_gap(prog[key], ref[key])
    key, how = name.split("_")
    g = list(leaf_gaps(prog, ref, key).values())
    return float(max(g) if how == "gap" else np.median(g))


def look(prog: dict, ref: dict) -> dict:
    """Per number the five leaves that read highest, for PERF.md's look."""
    out = {}
    for key in ("grad", "change", "ema"):
        g = leaf_gaps(prog, ref, key)
        out[key] = sorted(g.items(), key=lambda kv: -kv[1])[:5]
    return out


def control_readings(job: harness.Job, pool, ref: dict) -> dict:
    """The control (the reference in fp8 in the program's place) and the
    half-batch fault (the reference on the first half of each batch, its
    loss the mean over those rows) read as the program is."""
    from portbench.reference.model import fp8_round

    out = {}
    for name, kw in (("fp8", {"rounding": fp8_round}),
                     ("half_batch", {"rows": job.traffic["batch"] // 2})):
        r = reference_steps(job, pool, **kw)
        for k in READINGS:
            out[f"{name}.{k}"] = gap(r, ref, k)
    return out
