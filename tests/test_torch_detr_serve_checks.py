"""The checks that decide the Deformable DETR cell's ``correct``
(portbench/drivers/serve_detr.py) fail when the program is broken
underneath: a tiny CPU run of the cell (64 px canvas, batches of 2, fp32)
is correct as it stands, and turns false with perturbed sampling offsets
in the program (``out_gap``) and with an altered or reordered detection
(``select_mismatch``)."""

import json

import pytest
import torch

from multispectral_object_detection_tpu_torch.models.deformable_detr import (
    DeformableDETR, MSDeformAttn)
from portbench import harness
from portbench.drivers import serve_detr
from tests._torch_port import share_torch_threads  # noqa: F401

CELL = "serve-ddetr-r50-1024-bs8"
SEED = 3_000_000_123  # above 32 signed bits, as the driver's seeds are
DRAWN = {}  # the seeded weights, drawn once for every run of this module


@pytest.fixture
def run_tiny(monkeypatch):
    """The cell's driver at a size the CPU runs in seconds; the seeded
    weights drawn once for the program's build and the reference."""
    real = serve_detr.draw_state_dict

    def drawn(cfg, seed, device):
        key = (json.dumps(cfg, sort_keys=True), seed, str(device))
        if key not in DRAWN:
            DRAWN[key] = real(cfg, seed, device)
        return DRAWN[key]

    monkeypatch.setattr(serve_detr, "draw_state_dict", drawn)

    def run() -> harness.Outcome:
        job = harness.load_job(CELL, SEED, 0.1, False)
        job.device = "cpu"
        job.cfg = dict(job.cfg, canvas=64, frame_hw=[48, 64], dtype="float32")
        job.traffic = dict(job.traffic, batch=2, pool=2, sample_calls=2)
        return serve_detr.run(job)

    return run


def test_sound_run_is_correct(run_tiny):
    out = run_tiny()
    assert out.correct and out.checks["select_mismatch"][0] == 0
    assert out.checks["out_gap"][0] < 1e-5
    assert out.counters["msda_calls_per_call"] == 12


def test_perturbed_sampling_offsets_fail_out_gap(run_tiny, monkeypatch):
    real = serve_detr.build

    def perturbed(job):  # every sampling point a pixel to the right
        det = real(job)
        with torch.no_grad():
            for m in det.model.modules():
                if isinstance(m, MSDeformAttn):
                    m.sampling_offsets.bias[0::2] += 1.0
        return det

    monkeypatch.setattr(serve_detr, "build", perturbed)
    out = run_tiny()
    assert out.checks["out_gap"][0] > out.checks["out_gap"][1]
    assert not out.correct


@pytest.mark.parametrize("fault", ["moved", "swapped"])
def test_altered_detection_fails_select_mismatch(run_tiny, monkeypatch,
                                                 fault):
    real = DeformableDETR.select

    def altered(self, raw, conf, canvas):
        d = real(self, raw, conf, canvas)
        if fault == "moved":  # one box of each image a pixel to the right
            boxes = d.boxes.clone()
            boxes[:, 7, [0, 2]] += 1.0
            return d._replace(boxes=boxes)
        order = torch.arange(d.scores.shape[1])
        order[[0, 1]] = order[[1, 0]]  # the two best of each image swapped
        return d._replace(boxes=d.boxes[:, order], scores=d.scores[:, order],
                          classes=d.classes[:, order])

    monkeypatch.setattr(DeformableDETR, "select", altered)
    out = run_tiny()
    assert out.checks["select_mismatch"][0] > 0 and not out.correct
    assert out.checks["out_gap"][0] < out.checks["out_gap"][1]
