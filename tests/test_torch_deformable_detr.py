"""PyTorch port, Deformable DETR (models/deformable_detr.py, ops/msda.py)
against the benchmark's plain reference (portbench/reference/deformable_detr.py)
on seeded weights at the published widths and a small input, on the CPU:
the whole forward through ``hub.Detector``, the sampling op alone at
uneven level shapes, the top-100 rule on tied scores, the official
state-dict layout, that the drawn model is not degenerate, its spans and
counters, and that a single-stream model uploads one batch."""

import functools
import json

import numpy as np
import pytest
import torch

from multispectral_object_detection_tpu_torch.hub import Detector
from multispectral_object_detection_tpu_torch.models import deformable_detr
from multispectral_object_detection_tpu_torch.models.model import (
    build_model, load_reference_state_dict)
from multispectral_object_detection_tpu_torch.models.configs import get_config
from multispectral_object_detection_tpu_torch.ops.msda import ms_deform_attn
from multispectral_object_detection_tpu_torch.utils import tracing
from portbench import harness, work, work_detr
from portbench.reference import deformable_detr as ref_detr
from portbench.reference.deformable_detr_weights import (draw_state_dict,
                                                        grid_bias)
from tests._torch_port import share_torch_threads  # noqa: F401

CFG = json.loads((harness.HERE / "configs" / "deformable-detr-r50-1024.json")
                 .read_text())
SEED = 3_000_000_123
# Both sides compute in fp32. The port folds the frozen BatchNorms into the
# convolutions, samples channels last and runs the decoder's attention
# through SDPA, so its sums run in another order than the reference's:
# 5e-7 of the largest output was read. 1e-5 leaves 20 times that, and lies
# three orders below what computing in bf16 moves (about 6e-3 at this size).
FP32_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def weights(seed: int = SEED):
    return draw_state_dict(CFG, seed, "cpu")


@functools.lru_cache(maxsize=None)
def reference(seed: int = SEED):
    ref = ref_detr.build(CFG)
    ref.load_state_dict(weights(seed))
    return ref


@functools.lru_cache(maxsize=None)
def detector(img: int = 64):
    return Detector("deformable_detr_r50", state_dict=weights(), img_size=img,
                    conf=0.0, dtype=torch.float32, device="cpu")


def images(n: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, h, w, 3, generator=g) * 255).to(torch.uint8).numpy()


def as_input(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).float() / 255.0


def gap(p, r) -> float:
    return float((p - r).abs().max() / r.abs().max())


def test_program_config_is_the_published_one():
    prog = get_config("deformable_detr_r50")
    assert prog.pop("arch") == "deformable_detr"
    assert {k: CFG[k] for k in prog} == prog


@pytest.mark.parametrize("hw", [(64, 64), (64, 96)])
def test_forward_matches_reference(hw):
    """Logits and boxes, through the fused fp32 model; (64, 96) gives
    levels of unequal sides (8 x 12, 4 x 6, 2 x 3, 1 x 2)."""
    x = as_input(images(2, *hw))
    model = detector().model
    with torch.no_grad():
        logits, boxes = model(x)
        want_logits, want_boxes = reference()(x)
    assert logits.shape == (2, 300, 91) and boxes.shape == (2, 300, 4)
    assert gap(logits, want_logits) < FP32_TOL
    assert gap(boxes, want_boxes) < FP32_TOL


def test_infer_gives_the_reference_selection():
    """``Detector.infer`` on one stream: the reference's top 100 of its own
    outputs, boxes in canvas pixels."""
    x = images(2, 64, 64, seed=1)
    det = detector()
    dets = det.infer(x)
    with torch.no_grad():
        want = ref_detr.select(*reference()(as_input(x)), 100, 0.0, (64, 64))
    for i, (rb, rs, rc) in enumerate(want):
        assert dets.valid[i].all() and len(rb) == 100
        np.testing.assert_allclose(dets.scores[i].numpy(), rs, atol=1e-5)
        np.testing.assert_allclose(dets.boxes[i].numpy(), rb, atol=1e-3)
        assert (dets.classes[i].numpy() == rc).mean() > 0.95  # near-ties


def _msda_case():
    """Uneven levels, two heads of 4 channels, 3 points; locations inside,
    outside [0, 1] and exactly on pixel centres."""
    g = torch.Generator().manual_seed(7)
    shapes = [(5, 7), (3, 4), (2, 3), (1, 2)]
    n, q, m, d, p = 2, 6, 2, 4, 3
    s = sum(h * w for h, w in shapes)
    value = torch.randn(n, s, m, d, generator=g)
    loc = torch.rand(n, q, m, len(shapes), p, 2, generator=g) * 1.6 - 0.3
    for lid, (h, w) in enumerate(shapes):  # query 0: every point on a centre
        cols = torch.randint(0, w, (n, m, p), generator=g)
        rows = torch.randint(0, h, (n, m, p), generator=g)
        loc[:, 0, :, lid, :, 0] = (cols + 0.5) / w
        loc[:, 0, :, lid, :, 1] = (rows + 0.5) / h
    loc[:, 1] = torch.tensor([-0.6, 1.7])  # query 1: wholly outside
    logits = torch.randn(n, q, m, len(shapes) * p, generator=g)
    ref = torch.rand(n, q, 2, generator=g)
    norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32)
    offsets = (loc - ref[:, :, None, None, None]) * norm[:, None]
    return shapes, value, loc, logits, ref, offsets


def test_msda_matches_the_official_core():
    shapes, value, loc, logits, ref, offsets = _msda_case()
    n, q, m, nl, p, _ = loc.shape
    got = ms_deform_attn(value, shapes, ref, offsets.flatten(2),
                         logits.flatten(2), p)
    a = logits.softmax(-1).view(n, q, m, nl, p)
    want = ref_detr.ms_deform_attn_core(value, shapes, loc, a)
    assert got.shape == (n, q, m * value.shape[-1])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert got[:, 1].abs().max() == 0  # zeros outside every level


def test_msda_on_pixel_centres_reads_the_pixels():
    """One level, one point, weight 1: a sample on a pixel's centre is the
    pixel; half a pixel past the left edge is half the edge pixel."""
    h, w, d = 5, 7, 3
    value = torch.randn(1, h * w, 1, d)
    rows, cols = torch.tensor([0, 2, 4, 1]), torch.tensor([0, 3, 6, 5])
    loc = torch.stack([(cols + 0.5) / w, (rows + 0.5) / h], -1)
    loc = torch.cat([loc, torch.tensor([[0.0, 2.5 / h]])])[None]
    got = ms_deform_attn(value, [(h, w)], loc, torch.zeros(1, 5, 2),
                         torch.zeros(1, 5, 1), 1)[0]
    grid = value[0, :, 0].view(h, w, d)
    torch.testing.assert_close(got[:4], grid[rows, cols], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[4], grid[2, 0] / 2, rtol=0, atol=1e-6)


def test_top100_ties_go_to_the_lower_flat_index():
    """Scores tied in bf16: the program's and the reference's selections
    agree, and equal scores come in flat order q * 91 + class."""
    g = torch.Generator().manual_seed(3)
    logits = (torch.randn(2, 300, 91, generator=g) - 3).to(torch.bfloat16)
    logits[0] = -1.0  # image 0: every score equal
    logits = logits.float()
    boxes = torch.rand(2, 300, 4, generator=g) * 0.5 + 0.25
    model = detector().model
    dets = model.select((logits, boxes), 0.0, (64, 64))
    assert dets.boxes.shape == (2, 100, 4) and dets.classes.dtype == torch.int32
    flat = torch.arange(100)
    assert (dets.classes[0] == flat % 91).all()
    q = flat // 91
    want0 = boxes[0, q]
    torch.testing.assert_close(dets.boxes[0, :, 0],
                               (want0[:, 0] - want0[:, 2] / 2) * 64)
    for i, (rb, rs, rc) in enumerate(ref_detr.select(logits, boxes, 100, 0.0,
                                                     (64, 64))):
        assert (dets.classes[i].numpy() == rc).all()
        np.testing.assert_array_equal(dets.scores[i].numpy(), rs)
        np.testing.assert_allclose(dets.boxes[i].numpy(), rb, atol=1e-4)
    ties = dets.scores[1, 1:] == dets.scores[1, :-1]
    assert ties.any()  # bf16 logits do tie
    flat1 = (torch.arange(300)[:, None] * 91 + torch.arange(91)).flatten()
    order = logits[1].flatten().argsort(descending=True, stable=True)[:100]
    assert (dets.classes[1] == (flat1[order] % 91).int()).all()


OFFICIAL_KEYS = [
    "backbone.0.body.conv1.weight", "backbone.0.body.bn1.running_var",
    "backbone.0.body.layer1.0.downsample.0.weight",
    "backbone.0.body.layer1.0.downsample.1.running_mean",
    "backbone.0.body.layer4.2.bn3.weight", "backbone.0.body.layer3.5.conv2.weight",
    "input_proj.0.0.weight", "input_proj.3.0.bias", "input_proj.3.1.weight",
    "transformer.level_embed",
    "transformer.encoder.layers.5.self_attn.sampling_offsets.bias",
    "transformer.encoder.layers.0.self_attn.value_proj.weight",
    "transformer.encoder.layers.3.linear2.bias",
    "transformer.decoder.layers.0.self_attn.in_proj_weight",
    "transformer.decoder.layers.0.self_attn.out_proj.bias",
    "transformer.decoder.layers.5.cross_attn.attention_weights.weight",
    "transformer.decoder.layers.5.norm3.weight",
    "transformer.reference_points.weight", "query_embed.weight",
    "class_embed.0.weight", "class_embed.5.bias",
    "bbox_embed.0.layers.2.weight", "bbox_embed.5.layers.0.bias"]


def test_official_layout_loads():
    sd = weights()
    assert set(OFFICIAL_KEYS) <= set(sd) and len(sd) == 561
    assert not any(k.endswith("num_batches_tracked") for k in sd)
    ref = ref_detr.build(CFG)
    assert sum(p.numel() for p in ref.parameters()) == CFG["parameters"]
    model = build_model(get_config("deformable_detr_r50"))
    load_reference_state_dict(model, sd)  # raises on a key it cannot place
    st = model.state_dict()
    for port, official in [
            ("trunk.stem.conv.weight", "backbone.0.body.conv1.weight"),
            ("trunk.layer2.0.down.bn.running_var",
             "backbone.0.body.layer2.0.downsample.1.running_var"),
            ("trunk.layer3.4.cv2.bn.weight", "backbone.0.body.layer3.4.bn2.weight"),
            ("input_proj.3.norm.bias", "input_proj.3.1.bias"),
            ("class_embed.weight", "class_embed.5.weight"),
            ("bbox_embed.layers.2.bias", "bbox_embed.5.layers.2.bias"),
            ("transformer.decoder.layers.2.self_attn.in_proj_weight",
             "transformer.decoder.layers.2.self_attn.in_proj_weight")]:
        assert torch.equal(st[port], sd[official]), port
    # another decoder layer's copy of a head is not the one kept
    bad = dict(sd, **{"class_embed.0.weight": sd["class_embed.0.weight"] + 1})
    load_reference_state_dict(model, bad)
    assert torch.equal(model.state_dict()["class_embed.weight"],
                       sd["class_embed.5.weight"])


def test_random_weights_are_the_seeded_official_init():
    """Without weights the model takes the official initialisation from
    the generator: the same seed gives the same model, the offsets' bias
    is the published grid (as the benchmark's draw writes it)."""
    dets = [Detector("deformable_detr_r50", img_size=64, dtype=torch.float32,
                     device="cpu", generator=torch.Generator().manual_seed(1))
            for _ in range(2)]
    a, b = (d.model.state_dict() for d in dets)
    assert all(torch.equal(a[k], b[k]) for k in a)
    m = dets[0].model.transformer.encoder.layers[0].self_attn
    assert m.sampling_offsets.weight.abs().max() == 0
    torch.testing.assert_close(m.sampling_offsets.bias, grid_bias(8, 4, 4))
    out = dets[0].infer(images(1, 64, 64))
    assert torch.isfinite(out.boxes).all() and torch.isfinite(out.scores).all()


def test_drawn_model_is_not_degenerate(monkeypatch):
    """Every MSDA call samples non-zero values, the offsets move points by
    about 0.5-4 pixels of their level, and the top-100 scores differ."""
    outs, moves = [], []
    real = deformable_detr.ms_deform_attn

    def spy(value, shapes, reference, offsets, logits, points):
        moves.append(offsets.float().abs().median())
        out = real(value, shapes, reference, offsets, logits, points)
        outs.append(out)
        return out

    monkeypatch.setattr(deformable_detr, "ms_deform_attn", spy)
    dets = detector().infer(images(2, 64, 64, seed=2))
    assert len(outs) == 12
    for o in outs:
        assert (o != 0).float().mean() > 0.9
    assert 0.5 < float(torch.stack(moves).median()) < 4.0
    assert dets.scores.std() > 1e-3 and dets.scores[:, 0].min() > \
        dets.scores[:, -1].max()
    assert len(torch.unique(dets.boxes[0], dim=0)) > 50


def test_one_forward_opens_twelve_msda_spans():
    det = detector()
    before = tracing.counters("msda.")
    det.infer(images(2, 64, 64, seed=4))
    after = tracing.counters("msda.")
    ring = tracing.spans()
    root = next(s for s in reversed(ring) if s.name == "detector.infer")
    mine = [s for s in ring if s.request == root.request]
    names = {s.id: s.name for s in mine}
    msda = [s for s in mine if s.name == "msda"]
    assert len(msda) == 12
    assert sorted(names[s.parent] for s in msda) == \
        ["detr.decoder"] * 6 + ["detr.encoder"] * 6
    for name in ("detr.backbone", "detr.encoder", "detr.decoder",
                 "detr.select", "model.forward"):
        assert sum(s.name == name for s in mine) == 1
    tokens = sum(h * w for h, w in ref_detr.level_shapes((64, 64)))
    samples = 2 * 8 * 4 * 4 * 6 * (tokens + 300)
    assert after["msda.calls"] - before.get("msda.calls", 0) == 12
    assert after["msda.samples"] - before.get("msda.samples", 0) == samples


@pytest.mark.parametrize("cfg,uploads", [
    ("yolov5n", 1), ("yolov5n_fusion_add", 2), ("deformable_detr_r50", 1)])
def test_a_single_stream_model_uploads_one_batch(cfg, uploads):
    det = detector() if cfg.startswith("deformable") else Detector(
        cfg, nc=2, img_size=64, dtype=torch.float32, device="cpu")
    x = images(2, 64, 64, seed=5)
    det.infer(x, None if uploads == 1 else x)
    ring = tracing.spans()
    root = next(s for s in reversed(ring) if s.name == "detector.infer")
    assert sum(s.name == "detector.upload" and s.request == root.request
               for s in ring) == uploads


def test_work_counts_of_the_cell():
    """The yardstick of ``mfu.infer`` and ``msda_roofline.detr`` at the
    cell's shapes: 398.73 GFLOPs an image (grid_sample uncounted), and per
    forward at batch 8 six encoder calls of 445.6 MB and 7.13 GFLOPs and
    six decoder calls of 94.0 MB, 0.9666 ms at 3.35 TB/s."""
    hw = (CFG["canvas"], CFG["canvas"])
    assert work_detr.flops_per_image(CFG, hw) / 1e9 == pytest.approx(
        398.7347, abs=1e-4)
    calls = work_detr.msda_calls(CFG, 8, hw)
    assert len(calls) == 12 and calls[0] == (445_644_800, 7_130_316_800.0,
                                             "bf16")
    assert calls[-1] == (94_044_160, 98_304_000.0, "bf16")
    card = work.peaks("NVIDIA H100 80GB HBM3")
    assert work_detr.msda_bound_ms(CFG, 8, hw, card) == pytest.approx(
        0.96661, abs=1e-5)
