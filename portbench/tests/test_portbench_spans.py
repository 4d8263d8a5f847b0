"""The readers of the program's spans (launch_ms.serve,
upload_host_ms.serve, wait_ms.serve, nms_wait_ms.eval) on a hand-built
ring: each takes the median over the ring's calls or batches, and reads
nothing where the ring holds no span of its name."""

import pytest

from portbench import harness

tracing = pytest.importorskip(
    "multispectral_object_detection_tpu_torch.utils.tracing")


def _read(name, ctx=None):
    return harness.load_module(
        harness.HERE / "metrics" / f"{name}.py").read(ctx or {})


def test_span_readers_take_medians_over_the_ring(monkeypatch):
    reg = tracing.Registry()
    monkeypatch.setattr(tracing, "REGISTRY", reg)
    now = [0]
    monkeypatch.setattr(tracing, "perf_counter_ns", lambda: now[0])

    def spend(name, ms, inner=()):
        with reg.span(name):
            now[0] += int(ms * 1e6)
            for child in inner:
                spend(*child)

    assert all(_read(m) is None for m in (
        "launch_ms.serve", "upload_host_ms.serve", "wait_ms.serve"))
    # three served calls: (upload, forward, anchor copy wait, NMS exit
    # wait) ms
    for up, fw, anc, wait in ((3, 10, 15, 5), (4, 12, 20, 2), (5, 30, 1, 8)):
        spend("detector.infer", 0.5, [
            ("detector.upload", up / 2), ("detector.upload", up / 2),
            ("model.forward", fw, [("fusion.cft", 1)]),
            ("model.decode", 1, [("sync.decode_anchors", anc)]),
            ("nms", 0, [("nms.select", 1),
                        ("nms.suppress", 0, [("sync.nms_exit", wait)])])])
    assert _read("upload_host_ms.serve") == pytest.approx(4.0)
    assert _read("launch_ms.serve") == pytest.approx(12.0 + 1.0)
    assert _read("wait_ms.serve") == pytest.approx(20.0)  # 15 + 5
    assert _read("nms_wait_ms.eval", {"traffic": {"batch": 4}}) is None
    # two eval batches of 4 images, with 3 and 2 exit checks
    for waits in ((1, 2, 3), (4, 4)):
        spend("eval.batch", 1, [("eval.nms", 1, [("nms", 0, [(
            "nms.suppress", 0, [("sync.nms_exit", w) for w in waits])])])])
    assert _read("nms_wait_ms.eval", {"traffic": {"batch": 4}}) == \
        pytest.approx(7.0 / 4)
