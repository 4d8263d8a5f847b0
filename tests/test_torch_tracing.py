"""PyTorch port, the span-and-counter registry (utils/tracing.py): spans
nest per thread, share their root's request id and give self times; the
ring is bounded; under ``torch.profiler`` each span is a user annotation
and without one ``record_function`` is never entered; NMS's counters
give what its removed ``stats`` dict gave; short-lived threads leave no
counter table behind; the evaluator's times are its spans' sums; and
``Detector.infer`` yields its span tree."""

import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multispectral_object_detection_tpu_torch.hub import Detector
from multispectral_object_detection_tpu_torch.ops.nms import batched_nms
from multispectral_object_detection_tpu_torch.train.evaluator import evaluate
from multispectral_object_detection_tpu_torch.utils import tracing
from tests._torch_port import share_torch_threads  # noqa: F401
from tests.test_torch_eval import _fake_batches
from tests.test_torch_nms import CASES

# (candidates, iterations) that ``batched_nms(..., stats=stats)`` added for
# each case of tests/test_torch_nms.py before the registry replaced it
STATS = {"agnostic": (249, 100), "bf16_ties_multi_class": (238, 100),
         "class_mask": (240, 100), "class_mask_multi_label": (124, 100),
         "empty_image": (0, 0), "full_max_det": (128, 50),
         "hybrid_labels_injected": (2, 8), "labels_multi_label": (411, 100),
         "labels_single_class": (216, 100),
         "merge_3000_candidates": (3200, 300), "merge_keep_lone": (324, 100),
         "merge_one_candidate": (1, 8), "merge_redundant": (324, 100),
         "merge_tied_scores": (192, 32), "merge_with_labels": (413, 100),
         "mixed_batch": (47, 48), "multi_class_best": (245, 100),
         "multi_label": (324, 100), "single_class": (365, 176),
         "tied_scores": (192, 32)}


@pytest.fixture
def clock(monkeypatch):
    """The spans' clock, advanced by hand (ns)."""
    now = [0]
    monkeypatch.setattr(tracing, "perf_counter_ns", lambda: now[0])
    return now


def test_spans_nest_share_the_request_and_give_self_time(clock):
    reg = tracing.Registry()
    with reg.span("call") as call:
        clock[0] += 1_000_000
        with reg.span("upload") as up:
            clock[0] += 2_000_000
        with reg.span("nms") as nms:
            clock[0] += 1_000_000
            with reg.span("sync.exit") as sync:
                clock[0] += 3_000_000
        with reg.span("sync.fetch"):
            clock[0] += 500_000
    with reg.span("call") as again:
        clock[0] += 1_000_000
    assert (call.parent, call.request) == (None, call.id)
    assert up.parent == nms.parent == call.id and sync.parent == nms.id
    assert {up.request, nms.request, sync.request} == {call.id}
    assert again.request == again.id != call.id
    assert call.seconds == 0.0075 and sync.seconds == 0.003
    s = reg.summary()
    assert s["call"]["count"] == 2 and s["call"]["median_ms"] == 4.25
    assert s["nms"]["self_ms"] == 1.0  # 4 ms less its child's 3
    assert s["call"]["self_ms"] == 1.0  # both calls: 1 ms outside children
    assert reg.under("call", "sync.") == [3.5, 0.0]
    assert reg.under("call", "upload") == [2.0, 0.0]
    assert reg.under("call", "decode") == [] and reg.under("x", "sync.") == []


def test_the_ring_keeps_the_newest_spans():
    reg = tracing.Registry(maxlen=3)
    for i in range(5):
        with reg.span(f"s{i}"):
            pass
    assert [s.name for s in reg.spans()] == ["s2", "s3", "s4"]


def test_threads_keep_their_own_stacks_and_lose_no_count():
    reg = tracing.Registry()
    roots = []

    def work():
        with reg.span("root") as r:
            for _ in range(1000):
                reg.count("n")
                with reg.span("inner"):
                    pass
        roots.append(r)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert reg.counters() == {"n": 16 * 1000} and reg.counter("n") == 16000
    ids = {r.id for r in roots}
    inner = [s for s in reg.spans() if s.name == "inner"]
    assert len(ids) == 16 and len(inner) == 16000
    assert all(s.parent == s.request and s.parent in ids for s in inner)


def test_short_lived_threads_leave_no_table_behind():
    """A server that starts a thread a request (the REST server) counts
    into the one table: nothing grows with the threads, no count is
    lost."""
    reg = tracing.Registry()

    def request():
        reg.count("k1.x")
        reg.count("nms.candidates", torch.tensor(2))

    for _ in range(20):
        threads = [threading.Thread(target=request) for _ in range(25)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(reg._counts) == 2
    assert reg.counters() == {"k1.x": 500, "nms.candidates": 1000}


def test_device_tensor_counts_stay_tensors_until_read():
    reg = tracing.Registry()
    reg.count("c", torch.tensor(3))
    reg.count("c", torch.tensor(4))
    reg.count("i", 2)
    assert isinstance(reg.counter("c"), torch.Tensor)
    assert reg.counters() == {"c": 7, "i": 2} and reg.counters("i") == {"i": 2}
    assert reg.counter("missing") == 0


def test_spans_are_profiler_annotations_only_while_it_records(monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer.t"):
            with tracing.span("inner.t"):
                torch.ones(3).add_(1)
    ev = {e.name: e for e in prof.events() if e.name in ("outer.t",
                                                          "inner.t")}
    assert set(ev) == {"outer.t", "inner.t"}
    assert all(e.is_user_annotation for e in ev.values())
    assert ev["inner.t"].cpu_parent.name == "outer.t"
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    with tracing.span("outer.t"):
        with tracing.span("inner.t"):
            pass
    assert entered == []


def _case(name):
    make, kw = CASES[name]
    made = make(np.random.default_rng(len(name)))
    pred, labels, lmask = made if isinstance(made, tuple) else (made, None,
                                                                None)
    kw = dict(kw)
    if labels is not None:
        kw.update(labels=torch.from_numpy(labels),
                  labels_mask=torch.from_numpy(lmask))
    return torch.from_numpy(pred), kw


@pytest.mark.parametrize("name", sorted(CASES))
def test_nms_counters_give_what_its_stats_gave(name):
    pred, kw = _case(name)
    before = tracing.counters("nms.")
    with tracing.span("test") as root:
        batched_nms(pred, **kw)
    after = tracing.counters("nms.")
    got = {k: after[k] - before.get(k, 0) for k in after}
    assert (got["nms.candidates"], got["nms.iterations"]) == STATS[name]
    # a check every 8 iterations from 0, and one more if none is left
    it, every = got["nms.iterations"], 8
    checks = it // every + 1 if it < kw["max_det"] else -(-it // every)
    exits = [s for s in tracing.spans()
             if s.request == root.id and s.name == "sync.nms_exit"]
    assert "nms.exit_checks" not in got and len(exits) == checks


def test_nms_counts_nothing_while_exported():
    """torch.export traces with stand-ins for tensors: a count of one
    would not be a number, and would break the counter."""
    pred, kw = _case("hybrid_labels_injected")

    class Nms(torch.nn.Module):
        def forward(self, p, labels, labels_mask):
            return batched_nms(p, fixed_trip=True, **{
                **kw, "labels": labels, "labels_mask": labels_mask}).valid

    before = tracing.counters("nms.").get("nms.candidates", 0)
    torch.export.export(Nms(), (pred, kw["labels"], kw["labels_mask"]))
    batched_nms(pred, **kw)
    assert tracing.counters("nms.")["nms.candidates"] - before == 2


def test_counts_while_exported_leave_a_device_counter_real():
    """A counter that holds a tensor (K3's counts on CUDA), then counts of
    an int and of a tensor while torch.export traces: kept, either would
    turn the counter into the trace's stand-in, which later reads cannot
    turn into a number."""
    reg = tracing.Registry()
    reg.count("c", torch.tensor(3))

    class Counts(torch.nn.Module):
        def forward(self, x):
            reg.count("c", 300)
            reg.count("c", x.sum())
            return x + 1

    torch.export.export(Counts(), (torch.ones(2),))
    kept = reg.counter("c")
    assert type(kept) is torch.Tensor and reg.counters() == {"c": 3}


def test_evaluator_times_are_its_span_sums():
    batches, preds = _fake_batches()
    calls = []

    def forward(rgb, ir):
        calls.append(1)
        return torch.from_numpy(preds[len(calls) - 1]), None

    with tracing.span("test") as root:
        out = evaluate(forward, batches, 2, device="cpu", conf_thres=0.01)
    mine = [s for s in tracing.spans() if s.request == root.id]

    def ms(*names):
        return 1000.0 * sum(s.seconds for s in mine
                            if s.name in names) / out["seen"]

    assert out["t_infer_ms"] == pytest.approx(ms("eval.infer"), rel=1e-12)
    assert out["t_nms_ms"] == pytest.approx(ms("eval.nms"), rel=1e-12)
    assert out["t_match_ms"] == pytest.approx(
        ms("eval.match", "eval.summary"), rel=1e-12)
    batch = [s for s in mine if s.name == "eval.batch"]
    assert len(batch) == len(batches) and all(s.parent == root.id
                                              for s in batch)
    names = {s.name for s in mine if s.parent in {b.id for b in batch}}
    assert names == {"eval.infer", "eval.nms", "eval.match"}
    inside = {s.name for s in mine
              if s.parent in {x.id for x in mine if x.name == "eval.infer"}}
    assert inside == {"eval.upload", "eval.forward", "sync.eval_forward"}
    assert "sync.eval_fetch" in {
        s.name for s in mine
        if s.parent in {x.id for x in mine if x.name == "eval.nms"}}
    assert out["nms_candidates"] > 0 and out["nms_iterations"] > 0


def _tree(spans, sid):
    kids = sorted((s for s in spans if s.parent == sid),
                  key=lambda s: s.start_ns)
    return [(s.name, _tree(spans, s.id)) for s in kids]


def test_detector_infer_span_tree():
    det = Detector("yolov5n_fusion_transformerx3", nc=1, img_size=64,
                   device="cpu", conf=0.001)
    x = np.random.default_rng(0).integers(0, 255, (2, 64, 64, 3), np.uint8)
    det.infer(x, x)
    root = [s for s in tracing.spans() if s.name == "detector.infer"][-1]
    mine = [s for s in tracing.spans() if s.request == root.id]
    tree = _tree(mine, root.id)
    checks = sum(s.name == "sync.nms_exit" for s in mine)
    assert checks >= 1
    assert tree == [
        ("detector.upload", []), ("detector.upload", []),
        ("model.forward", [("fusion.cft", [])] * 3),
        ("model.decode", [("sync.decode_anchors", [])] * 3),
        ("nms", [("nms.select", []),
                 ("nms.suppress", [("sync.nms_exit", [])] * checks)])]
