"""The check that decides ``correct`` fails when the timed path is broken
underneath: each fault that a cell can have, planted in the program, turns
a tiny CPU run's ``correct`` false (the readied train mix's too); and the
control, the reference in fp8 put in the program's place, fails each
cell's limits."""

import pytest
import torch

from multispectral_object_detection_tpu_torch import hub
from multispectral_object_detection_tpu_torch.models.model import (
    DetectionModel)
from multispectral_object_detection_tpu_torch.ops import nms as port_nms
from portbench.drivers import serve
from portbench.reference.model import ReferenceModel, fp8_round
from portbench.tests._tiny import run_tiny
from portbench.weights import draw_state_dict

SERVE = ["serve-l640-bs16", "serve-x1024-bs8"]
INFER = SERVE + ["eval-l640-bs32"]


def test_sound_run_is_correct():
    assert run_tiny(SERVE[0]).correct


@pytest.mark.parametrize("cell", INFER)
def test_altered_answer_fails(cell, monkeypatch):
    from multispectral_object_detection_tpu_torch.train import evaluator

    real = port_nms.batched_nms

    def altered(*a, **kw):
        d = real(*a, **kw)
        return d._replace(boxes=d.boxes + d.valid[..., None].float())

    monkeypatch.setattr(hub, "batched_nms", altered)
    monkeypatch.setattr(evaluator, "batched_nms", altered)
    out = run_tiny(cell)
    assert out.checks["nms_mismatch"][0] > 0 and not out.correct


@pytest.mark.parametrize("cell", INFER)
def test_half_the_batch_left_out_fails(cell, monkeypatch):
    real = DetectionModel.forward

    def half(self, x, x2=None, **kw):
        n = len(x) // 2
        out = real(self, x[:n], x2[:n], **kw)
        return tuple(torch.cat([o, torch.zeros_like(o)]) for o in out)

    monkeypatch.setattr(DetectionModel, "forward", half)
    out = run_tiny(cell)
    assert out.checks["head_gap"][0] > 0.5 and not out.correct


class Fp8InPlace:
    """The reference computed in fp8, in the program's place: its head
    outputs and the program's own decode and NMS over them."""

    def __init__(self, job):
        self.model = ReferenceModel(job.model_cfg, fp8_round)
        self.model.load_state_dict(draw_state_dict(job.cfg, job.seed, "cpu"))
        self.model.eval()
        self.tr = job.traffic

    @torch.no_grad()
    def infer(self, rgb, ir):
        x, x2 = (torch.from_numpy(t).permute(0, 3, 1, 2).float() / 255
                 for t in (rgb, ir))
        raw = self.model(x, x2)
        return port_nms.batched_nms(
            serve.decode(raw, self.model.anchors, self.model.strides),
            conf_thres=self.tr["conf"], iou_thres=self.tr["iou"],
            max_det=self.tr["max_det"], top_k=self.tr["top_k"])


@pytest.mark.parametrize("cell", SERVE)
def test_control_fails_the_limit(cell, monkeypatch):
    monkeypatch.setattr(serve, "build", Fp8InPlace)
    out = run_tiny(cell)
    assert not out.correct
    assert out.checks["head_gap"][0] > out.checks["head_gap"][1]


class Fp8Model(torch.nn.Module):
    """The fp8 reference as the eval path's model: forward and decode."""

    def __init__(self, job):
        super().__init__()
        self.ref = Fp8InPlace(job).model
        self.spec = type("Spec", (), {"two_stream": True})

    def forward(self, x, x2):
        with torch.no_grad():
            return self.ref(x, x2)

    def decode(self, feats):
        return serve.decode(feats, self.ref.anchors, self.ref.strides)


def test_eval_control_fails_the_limit(monkeypatch):
    from portbench.drivers import eval as ev

    monkeypatch.setattr(ev, "build", Fp8Model)
    out = run_tiny("eval-l640-bs32")
    assert out.checks["head_gap"][0] > out.checks["head_gap"][1]
    assert not out.correct


# ----------------------------------------------------------------- training
TRAIN = "train-l640-bs16"


def test_sound_train_run_is_correct():
    out = run_tiny(TRAIN)
    assert out.correct, out.checks


def wrap_step(monkeypatch, wrapper):
    """Plant a fault in the program's train step."""
    from multispectral_object_detection_tpu_torch.train import trainer

    real = trainer.make_train_step

    def make(state, loss_fn, remat="none"):
        return wrapper(real(state, loss_fn, remat), state)

    monkeypatch.setattr(trainer, "make_train_step", make)


def test_state_left_unchanged_fails(monkeypatch):
    def frozen(step, state):
        def run(rgb, ir, targets, tmask, seed):
            saved = [p.detach().clone() for p in state.opt.params]
            ema = [t.detach().clone() for t in
                   state.ema_model.state_dict().values()]
            out = step(rgb, ir, targets, tmask, seed=seed)
            with torch.no_grad():
                for p, s in zip(state.opt.params, saved):
                    p.copy_(s)
                for t, s in zip(state.ema_model.state_dict().values(), ema):
                    t.copy_(s)
            return out
        return run

    wrap_step(monkeypatch, frozen)
    out = run_tiny(TRAIN)
    assert out.checks["change_med"][0] > 0.5 and not out.correct


def test_half_the_train_batch_left_out_fails(monkeypatch):
    def half(step, state):
        def run(rgb, ir, targets, tmask, seed):
            n = len(rgb) // 2
            keep = targets[:, 0] < n
            return step(rgb[:n], ir[:n], targets[keep], tmask[keep],
                        seed=seed)
        return run

    wrap_step(monkeypatch, half)
    out = run_tiny(TRAIN)
    assert not out.correct
