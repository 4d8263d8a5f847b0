"""Spans and counters at the port's layer boundaries, on the host's clock
and, while ``torch.profiler`` records, on the profiler's.

``span(name)`` times a ``with`` block: each span records its name, its
start and end (``time.perf_counter_ns``), its own id, the id of the span
that encloses it on the same thread (``parent``) and the id of the
outermost one (``request``: a span with no parent starts a request, and
every span inside it shares its id). Finished spans go into a bounded
ring (``RING`` spans, oldest dropped first), which ``spans``,
``summary`` and ``under`` read. A span reads no device state: it costs
about a microsecond and records always. While a ``torch.profiler`` is
recording, a span also enters ``torch.profiler.record_function(name)``,
so that the trace holds it as a host range (and a ``gpu_user_annotation``
over what it launched) beside the device's kernels and idle gaps; with no
profiler it does not, as that costs ten times the span itself.

``count(name, n)`` adds ``n`` to a named counter, in one table that
every thread adds to under a lock. ``n`` may be a device tensor: the sum
stays on the device and is read to the host only when ``counters`` reads
it, so counting adds no synchronisation. A count on another card than
the counter's is copied to the counter's card (on the devices' streams,
not through the host). Nothing counted while
``torch.export`` traces is kept: its tensors are stand-ins, and even an
int added to a counter that holds a device tensor would turn the counter
into one.

Spans: ``detector.infer``, ``detector.upload`` (hub.Detector);
``model.forward``, ``model.decode`` (models/model.DetectionModel);
``sync.decode_anchors`` (each scale's blocking anchor copy, models/detect);
``fusion.cft`` (each CFT stage's stack, models/fusion); ``nms``,
``nms.select``, ``nms.suppress``, ``sync.nms_exit`` (ops/nms);
``eval.batch``, ``eval.infer``, ``eval.upload``, ``eval.forward``,
``sync.eval_forward``, ``eval.nms``, ``sync.eval_fetch``, ``eval.match``,
``eval.summary`` (train/evaluator); ``sync.nms_exit`` only on NMS's plain
path (CPU tensors), as K3 reads nothing back; ``detr.backbone``,
``detr.encoder``, ``detr.decoder``, ``detr.select``
(models/deformable_detr), ``msda`` (ops/msda, each deformable-attention
sampling call) and ``k4.msda`` (inside ``msda``, each K4 launch).
Counters: ``nms.candidates`` and ``nms.iterations`` (ops/nms: on the CPU
the candidates read by the first exit check and the loop's steps, host
ints; on CUDA device tensors that K3 wrote, the candidates and the batch's
largest number of picks);
``k1.<kernel>`` (ops/cft_stack), ``k2.c3_bottleneck`` (ops/c3_bottleneck),
``k3.nms_suppress`` (ops/nms) and ``k4.msda`` (ops/msda), one per kernel
launch; ``msda.calls`` and ``msda.samples`` (ops/msda: calls, and
queries x heads x levels x points sampled).
"""

from __future__ import annotations

import threading
from collections import deque
from itertools import count as _ids
from time import perf_counter_ns
from typing import Dict, List

import numpy as np
import torch

RING = 65536  # finished spans kept: about 15 per served call, 57 per eval batch
_profiler_enabled = torch.autograd._profiler_enabled
_is_compiling = torch.compiler.is_compiling


class Span:
    """One timed range; ``seconds`` is its length once it has ended."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "request",
                 "_reg", "_annotation")

    def __init__(self, name: str, registry: "Registry"):
        self.name = name
        self._reg = registry

    def __enter__(self) -> "Span":
        reg = self._reg
        try:
            stack = reg._local.stack
        except AttributeError:  # the thread's first span
            stack = reg._local.stack = []
        self.id = next(reg._ids)
        if stack:
            self.parent, self.request = stack[-1].id, stack[-1].request
        else:
            self.parent, self.request = None, self.id
        stack.append(self)
        self._annotation = None
        if _profiler_enabled():
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        self.start_ns = perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = perf_counter_ns()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        self._reg._local.stack.pop()
        self._reg._ring.append(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Registry:
    """A ring of finished spans and a table of counters; the port records
    into ``REGISTRY``."""

    def __init__(self, maxlen: int = RING):
        self._ring: deque = deque(maxlen=maxlen)
        self._local = threading.local()
        self._ids = _ids(1)
        self._counts: dict = {}  # one table for every thread
        self._lock = threading.Lock()

    def span(self, name: str) -> Span:
        return Span(name, self)

    def count(self, name: str, n=1) -> None:
        if _is_compiling():
            return  # a trace, not a call
        with self._lock:
            held = self._counts.get(name, 0)
            if (isinstance(n, torch.Tensor) and isinstance(held, torch.Tensor)
                    and n.is_cuda and held.is_cuda
                    and n.device != held.device):
                n = n.to(held.device, non_blocking=True)
            self._counts[name] = held + n

    def counter(self, name: str):
        """The counter as kept (a device tensor stays on the device)."""
        with self._lock:
            return self._counts.get(name, 0)

    def counters(self, prefix: str = "") -> Dict[str, int]:
        """The counters whose names start with ``prefix``, on the host."""
        with self._lock:
            table = dict(self._counts)
        return {k: int(v) for k, v in sorted(table.items())
                if k.startswith(prefix)}

    def spans(self) -> List[Span]:
        return list(self._ring)

    def summary(self) -> Dict[str, dict]:
        """Per span name in the ring: ``count``, ``median_ms``, ``p95_ms``
        and ``self_ms``, the median of each span's length less the part
        its children cover."""
        ring = self.spans()
        inner: Dict[int, int] = {}
        for s in ring:
            if s.parent is not None:
                inner[s.parent] = inner.get(s.parent, 0) + s.end_ns - s.start_ns
        by_name: Dict[str, list] = {}
        for s in ring:
            ns = s.end_ns - s.start_ns
            by_name.setdefault(s.name, []).append((ns, ns - inner.get(s.id, 0)))
        out = {}
        for name, rows in by_name.items():
            ms = np.array(rows, dtype=np.float64) / 1e6
            out[name] = {"count": len(rows),
                         "median_ms": float(np.median(ms[:, 0])),
                         "p95_ms": float(np.percentile(ms[:, 0], 95)),
                         "self_ms": float(np.median(ms[:, 1]))}
        return out

    def under(self, root: str, prefix: str) -> List[float]:
        """For each span named ``root`` in the ring, oldest first, the
        summed ms of its descendants whose names start with ``prefix``
        (a match inside a match counts twice); empty when no such
        descendant is in the ring."""
        ring = self.spans()
        kids: Dict[int, list] = {}
        for s in ring:
            if s.parent is not None:
                kids.setdefault(s.parent, []).append(s)
        out, found = [], False
        for s in ring:
            if s.name != root:
                continue
            total, todo = 0, list(kids.get(s.id, ()))
            while todo:
                c = todo.pop()
                if c.name.startswith(prefix):
                    total += c.end_ns - c.start_ns
                    found = True
                todo.extend(kids.get(c.id, ()))
            out.append(total / 1e6)
        return out if found else []


REGISTRY = Registry()
span = REGISTRY.span    # ``with span("nms"): ...``
count = REGISTRY.count  # ``count("k1.cft_attention")``


def counter(name: str):
    return REGISTRY.counter(name)


def counters(prefix: str = "") -> Dict[str, int]:
    return REGISTRY.counters(prefix)


def spans() -> List[Span]:
    return REGISTRY.spans()


def summary() -> Dict[str, dict]:
    return REGISTRY.summary()


def under(root: str, prefix: str) -> List[float]:
    return REGISTRY.under(root, prefix)

