"""The harness's common parts: finding a cell's files by name, the guard
against JAX, the card's identity, the profiler's reduction to kernels,
busy time and idle gaps, the per-layer readers, and the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``, which names its driver,
``drivers/<driver>.py``); its correctness limits are ``limits/<cell>.json``
and each per-layer metric is read by ``metrics/<metric>.py``. A later
change adds a cell, a configuration, a mix or a metric by adding files.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "multispectral_object_detection_tpu")
TOP = 10  # entries of each list of the breakdown
# cells whose files are here but that BENCHMARK.json does not hold yet
# (PERF.md, Open questions: why), for the tests and portbench/control.py
READIED = {"train-l640-bs16": {"name": "train-l640-bs16",
                               "config": "cft-l-llvip-640",
                               "traffic": "train-bs16", "chips": 1}}
MODEL_KEYS = ("nc", "depth_multiple", "width_multiple", "anchors",
              "backbone", "head")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that a run may not load, each
    name compared whole (the program's own name begins with one)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cache_dirs() -> Dict[str, str]:
    """Build and kernel caches at fixed places inside the checkout."""
    base = ROOT / ".portbench_cache"
    return {"TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "TRITON_CACHE_DIR": str(base / "triton")}


def read_json(path: Path) -> dict:
    return json.loads(path.read_text())


@dataclass
class Job:
    """One run of one cell."""

    workload: dict
    cfg: dict
    traffic: dict
    limits: dict
    per_layer: List[dict]
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t0: float = field(default_factory=time.perf_counter)
    control: bool = False  # also read the control (portbench/control.py)

    @property
    def model_cfg(self) -> dict:
        return {k: self.cfg[k] for k in MODEL_KEYS}


def load_job(name: str, seed: int, seconds: float, trace: bool,
             t0: Optional[float] = None) -> Job:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``READIED``) with
    its files."""
    bench = read_json(ROOT / "BENCHMARK.json")
    cells = {**READIED, **{w["name"]: w for w in bench["workloads"]}}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    metrics = [m for m in bench["per_layer"]
               if name in m.get("workloads", [name])]
    job = Job(workload=w, cfg=read_json(ROOT / conf["file"]),
              traffic=read_json(HERE / "traffic" / f"{w['traffic']}.json"),
              limits=read_json(HERE / "limits" / f"{name}.json"),
              per_layer=metrics, seed=seed, seconds=seconds, trace=trace)
    if t0 is not None:
        job.t0 = t0
    return job


def load_module(path: Path):
    """A module from a file (names may hold dots and dashes)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(job: Job):
    """The mix's driver, ``portbench.drivers.<driver>``."""
    return importlib.import_module(f"portbench.drivers.{job.traffic['driver']}")


def read_per_layer(job: Job, ctx: dict) -> Dict[str, dict]:
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing to read returns None and its metric is left out."""
    out = {}
    for m in job.per_layer:
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def card_info(device) -> Dict[str, object]:
    """The card's name, power limit and count (``platform`` gpu), or the
    CPU's stand-in for tests."""
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "power_limit": None}
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "not read"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "power_limit": limit}


def quarter_rates(ends: List[float], t0: float, t1: float,
                  per: float) -> List[float]:
    """Work per second in each quarter of the window [t0, t1], from the
    times at which each unit of ``per`` items ended: whether a run's rate
    drifts within its window, or only between runs."""
    q = (t1 - t0) / 4
    return [per * sum(t0 + i * q < e <= t0 + (i + 1) * q for e in ends) / q
            for i in range(4)]


def peak_bytes(device) -> int:
    import torch

    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated())


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ------------------------------------------------------------- the trace
def profile_calls(fn: Callable[[], None], calls: int, device,
                  gap_calls: int = 4) -> dict:
    """``reduce_trace`` of ``calls`` calls of ``fn()`` traced with the
    device's activity alone (kernels and copies; the host pays only the
    launch callbacks), then the idle gaps of ``gap_calls`` more calls
    traced with the host's operators too, which name each gap. Each trace
    starts with one call as the profiler's warm-up step (kernels launched
    just after tracing starts can go unrecorded)."""
    import torch
    from torch.profiler import ProfilerActivity

    cuda = torch.device(device).type == "cuda"
    dev_acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    prof, wall = _traced(fn, calls, device, dev_acts)
    out = reduce_trace(prof, calls, wall)
    if cuda:
        prof, wall = _traced(fn, gap_calls, device,
                             [ProfilerActivity.CPU, ProfilerActivity.CUDA])
        out["gaps"] = reduce_trace(prof, gap_calls, wall)["gaps"]
    return out


def _traced(fn, calls: int, device, activities):
    from torch.profiler import profile, schedule

    with profile(activities=activities, schedule=schedule(
            wait=0, warmup=1, active=calls, repeat=1)) as prof:
        fn()
        sync(device)
        prof.step()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
            prof.step()
        sync(device)
        wall = time.perf_counter() - t0
    return prof, wall


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_trace(prof, calls: int, wall_s: float) -> dict:
    """Kernels and copies by name ({name: [device ms, launches]} over the
    traced calls), the device's busy seconds (the union of their
    intervals), the traced wall time, and the longest idle gaps, each
    named by the innermost host operation that was running at its start."""
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.name.startswith("ProfilerStep") or getattr(
                e, "is_user_annotation", False):
            continue  # the schedule's own spans, on the host and the device
        if e.device_type.name == "CUDA":
            dev.append((e.name, tr.start, tr.end))
        elif e.device_type.name == "CPU":
            host.append((e.name, tr.start, tr.end))
    kernels: Dict[str, List[float]] = {}
    for name, a, b in dev:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (b - a) / 1e3
        k[1] += 1
    busy = _union([(a, b) for _, a, b in dev])
    gaps = sorted(((start - end) / 1e6, end) for (_, end), (start, _)
                  in zip(busy, busy[1:]))[::-1][:TOP]
    named = []
    for seconds, end in gaps:
        under = [h for h in host if h[1] <= end < h[2]]
        named.append((min(under, key=lambda h: h[2] - h[1])[0] if under
                      else "host idle", seconds))
    return {"kernels": kernels, "calls": calls, "window_s": wall_s,
            "busy_s": sum(b - a for a, b in busy) / 1e6, "gaps": named}


def breakdown(trace: dict) -> dict:
    top = sorted(trace["kernels"].items(), key=lambda kv: -kv[1][0])[:TOP]
    return {"device_ops": [[n, v[0] / 1e3] for n, v in top],
            "idle_gaps": [[n, s] for n, s in trace["gaps"]]}


def kinds_ms(trace: dict, kinds: Dict[str, List[str]]) -> Dict[str, float]:
    """Device ms per traced call by kind: each kernel goes to the first
    kind with a pattern in its lower-cased name, else to "other"."""
    out = {k: 0.0 for k in (*kinds, "other")}
    for name, (ms, _) in trace["kernels"].items():
        low = name.lower()
        kind = next((k for k, pats in kinds.items()
                     if any(p in low for p in pats)), "other")
        out[kind] += ms / trace["calls"]
    return out


def patterns(metric: str) -> dict:
    return read_json(HERE / "metrics" / f"{metric}.json")


# ------------------------------------------------------------ the result
@dataclass
class Outcome:
    """What a driver hands back: the metrics (end-to-end with trace off,
    per-layer with trace on), the checks {name: (value, limit)}, and the
    rest of the result line."""

    attempted: int
    failed: int
    metrics: Dict[str, dict]
    checks: Dict[str, Tuple[float, float]]
    device: Dict[str, object]
    breakdown: Optional[dict] = None
    counters: Dict[str, object] = field(default_factory=dict)
    control: Dict[str, float] = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.checks.values())


def result_line(out: Outcome) -> str:
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": out.metrics,
            "device": out.device}
    if out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["counters"] = out.counters
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in out.checks.items()}
    return json.dumps(line)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def print_checks(out: Outcome) -> None:
    for k, (v, lim) in out.checks.items():
        log(f"check {k}: {v!r} limit {lim!r} "
            f"{'ok' if v <= lim else 'FAILED'}")
