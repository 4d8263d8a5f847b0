"""Device time of the serving forward by kernel and by kind of operation:
the port's counterpart of ``tools/profile_model.py``, with its flags and
output lines, on ``torch.profiler``.

    python -m multispectral_object_detection_tpu_torch.tools.profile_model \\
        [--cfg-scale l] [--img 640] [--batch 16] [--iters 3] [--top 30]
        [--no-nms] [--c3-kernel] [--device cuda]

The model is the bench's (``bench.prepare``: random weights from a seed,
BN folded, bf16, the CFT stages through K1, the C3 bottlenecks through K2
with ``--c3-kernel``), and one iteration is its ``infer``: the eager
forward, decode and NMS (unless ``--no-nms``) of a uint8 batch already on
the card. After one warm-up iteration and one more as the profiler's
warm-up step, ``--iters`` iterations run under the profiler (CPU and CUDA
activities). Prints the device ms per
iteration, the host ms per iteration (the profiler's own cost included)
and the device idle share, the device ms and launches by kind of
operation, the device's idle ms and the host ms by program span
(``idle_by_span``), and the ``--top`` kernels by device time. It raises
if the profiler records no CUDA kernel. With ``--device cpu`` the
"device" is the host: the self time of the ``aten::`` operators.

``by_kind`` groups kernels by the first row of a table of name patterns
that matches: ``SERVING_KINDS`` for a forward, ``TRAIN_KINDS`` for a
train step (chip_smoke.py phases 4, 7, 8 and 11 print theirs through it).
"""

from __future__ import annotations

import argparse
import sys
import time

SERVING_KINDS = {  # first match wins
    "CFT kernels": ("layernorm_kernel", "gemm_wgmma_kernel",
                    "gemm_f32_kernel", "attention_mma_kernel",
                    "attention_f32_kernel"),
    "C3 kernel (K2)": ("conv_wgmma_kernel", "conv_f32_kernel"),
    "convolution": ("fprop", "conv", "xmma", "implicit"),
    "silu": ("silu",),
    "other elementwise (bias add, residual add)": ("elementwise",),
    "pooling": ("pool",),
    "cat/copy/resize": ("cat", "copy", "upsample", "interp"),
}
TRAIN_KINDS = {  # first match wins
    "convolution": ("conv", "fprop", "dgrad", "wgrad", "implicit", "xmma",
                    "cudnn"),
    "batch norm": ("batch_norm",),
    "optimizer and EMA (foreach)": ("multi_tensor_apply",),
    "matmul": ("gemm", "cutlass", "sm90"),
    "loss gather and scatter": ("index", "scatter"),
    "elementwise": ("elementwise",),
    "reductions": ("reduce",),
    "copy/cat/resize": ("copy", "cat", "upsample", "interp"),
}


def kernel_events(prof, device: str = "cuda") -> list:
    """[(name, ms, launches)] of what ``prof`` (a finished
    ``torch.profiler.profile``) recorded on the device: the CUDA kernels,
    or with ``device="cpu"`` the self time of the ``aten::`` operators.
    The program's spans (user annotations, on the host and as
    ``gpu_user_annotation`` ranges on the device) are not kernels."""
    out = []
    for e in prof.key_averages():
        if e.key.startswith("ProfilerStep") or e.is_user_annotation:
            continue
        if device == "cpu":
            if e.device_type.name == "CPU" and e.key.startswith("aten::") \
                    and e.self_cpu_time_total > 0:
                out.append((e.key, e.self_cpu_time_total / 1e3, e.count))
        elif e.device_type.name == "CUDA" and e.self_device_time_total > 0:
            out.append((e.key, e.self_device_time_total / 1e3, e.count))
    return out


def by_kind(kernels, kinds: dict, runs: int = 1) -> dict:
    """{kind: {"ms", "launches"} per run} of ``kernels`` ([(name, ms,
    launches)] over ``runs`` runs): each kernel goes to the first kind of
    ``kinds`` ({kind: name substrings}, matched lower-case) with a pattern
    in its name, else to "other". Raises ValueError on no kernels."""
    if not kernels:
        raise ValueError("no kernels to group: the profiler recorded no "
                         "device events")
    out = {k: {"ms": 0.0, "launches": 0} for k in (*kinds, "other")}
    for name, ms, n in kernels:
        low = name.lower()
        kind = next((k for k, pats in kinds.items()
                     if any(p in low for p in pats)), "other")
        out[kind]["ms"] += ms / runs
        out[kind]["launches"] += n
    for v in out.values():
        v["launches"] //= runs
    return out


def idle_by_span(events, runs: int = 1, device: str = "cuda") -> dict:
    """{span: {"idle_ms", "host_ms"}} per run from the events of a finished
    ``torch.profiler`` trace with the host's activity: each gap between
    the device's busy intervals (the union of its kernels and copies; on
    the CPU, of the ``aten::`` operators) is charged to the innermost
    program span (utils/tracing: a user annotation on the host) running at
    the gap's start, or to "(no span)"; ``host_ms`` is each span's summed
    length."""
    busy, spans = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.name.startswith("ProfilerStep"):
            continue
        if e.is_user_annotation:
            if e.device_type.name == "CPU":
                spans.append((e.name, a, b))
        elif device == "cpu" and e.device_type.name == "CPU":
            if e.name.startswith("aten::"):
                busy.append((a, b))
        elif device != "cpu" and e.device_type.name == "CUDA":
            busy.append((a, b))
    union = []
    for a, b in sorted(busy):
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    out = {}
    for name, a, b in spans:
        out.setdefault(name, {"idle_ms": 0.0, "host_ms": 0.0})
        out[name]["host_ms"] += (b - a) / 1e3 / runs
    for (_, end), (start, _) in zip(union, union[1:]):
        under = [sp for sp in spans if sp[1] <= end < sp[2]]
        name = min(under, key=lambda sp: sp[2] - sp[1])[0] if under \
            else "(no span)"
        out.setdefault(name, {"idle_ms": 0.0, "host_ms": 0.0})
        out[name]["idle_ms"] += (start - end) / 1e3 / runs
    return out


def profile(fn, kinds: dict, runs: int = 2, warmup: int = 1,
            device: str = "cuda") -> dict:
    """``fn()`` ``warmup`` times, then under ``torch.profiler`` once more as
    the profiler's own warm-up step (tracing starts; its events are
    dropped: kernels launched just after tracing is switched on can go
    unrecorded) and ``runs`` times recorded: host and device ms per run,
    the device's idle share (1 - device / host), launches per run, the
    kernels and their kinds, and ``idle_by_span``. Raises RuntimeError if
    nothing ran on the device."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import schedule

    cuda = device != "cpu"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    for _ in range(warmup):
        fn()
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with tprofile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=runs, repeat=1)) as prof:
        fn()
        sync()
        prof.step()
        t0 = time.perf_counter()
        for i in range(runs):
            fn()
            if i == runs - 1:
                sync()
                host = (time.perf_counter() - t0) * 1e3 / runs
            prof.step()
    kernels = kernel_events(prof, "cpu" if not cuda else "cuda")
    if not kernels:
        raise RuntimeError("torch.profiler recorded no "
                           f"{'CUDA kernel' if cuda else 'aten operator'}")
    dev = sum(ms for _, ms, _ in kernels) / runs
    return {"host_ms": host, "device_ms": dev, "idle": 1 - dev / host,
            "launches": sum(n for _, _, n in kernels) // runs,
            "by_kind": by_kind(kernels, kinds, runs),
            "kernels": sorted(kernels, key=lambda k: -k[1]), "runs": runs,
            "spans": idle_by_span(prof.events(), runs,
                                  "cpu" if not cuda else "cuda")}


def spans_table(spans: dict) -> str:
    """``idle_by_span``'s result as lines, the most idle first."""
    rows = sorted(spans.items(), key=lambda kv: -kv[1]["idle_ms"])
    return "\n".join([f"{'idle ms':>8}  {'host ms':>8}  span (device idle "
                      "by the span running at the gap's start)"]
                     + [f"{v['idle_ms']:8.3f}  {v['host_ms']:8.3f}  {k}"
                        for k, v in rows])


def kinds_line(res: dict) -> str:
    return ", ".join(f"{k} {v['ms']:.3f} ms x{v['launches']}"
                     for k, v in res["by_kind"].items())


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        "python -m multispectral_object_detection_tpu_torch.tools."
        "profile_model")
    ap.add_argument("--cfg-scale", default="l")
    ap.add_argument("--img", type=int, default=640)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--no-nms", action="store_true")
    ap.add_argument("--c3-kernel", action="store_true",
                    help="the C3 bottlenecks through K2, as the bench's "
                         "--c3-kernel")
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (fails without a GPU), 'cuda:N' or 'cpu'")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Build the bench's model, profile ``--iters`` iterations of its
    ``infer`` and print the report; returns ``profile``'s result."""
    from .. import bench

    bargs = bench.parse_args(["--batch", str(args.batch), "--img",
                              str(args.img), "--scale", args.cfg_scale,
                              "--device", args.device]
                             + ["--no-nms"] * args.no_nms
                             + ["--c3-kernel"] * args.c3_kernel)
    _, infer, rgb, ir = bench.prepare(bargs)
    res = profile(lambda: infer(rgb, ir), SERVING_KINDS, runs=args.iters,
                  device=rgb.device.type)
    print(f"TOTAL device: {res['device_ms']:.3f} ms/iter "
          f"({res['launches']} launches/iter) on {bench.card(rgb.device)}")
    print(f"host: {res['host_ms']:.3f} ms/iter (profiled); device idle "
          f"{res['idle']:.1%}")
    print(f"by kind: {kinds_line(res)}\n")
    print(spans_table(res["spans"]) + "\n")
    print(f"{'ms/iter':>8}  {'calls':>5}  kernel")
    for name, ms, n in res["kernels"][:args.top]:
        print(f"{ms / args.iters:8.3f}  {n // args.iters:5d}  {name[:100]}")
    return res


def main(argv=None) -> int:
    from ..utils.general import select_device

    args = parse_args(argv)
    try:
        select_device(args.device)
    except RuntimeError as e:
        print(f"profile_model: {e}", file=sys.stderr)
        return 1
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
