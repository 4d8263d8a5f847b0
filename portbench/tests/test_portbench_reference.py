"""The plain reference against the port at the n scale on the CPU, in fp32:
raw head outputs, decode and NMS; and the reference and the rest of the
yardstick import nothing of the port, of JAX or of the JAX package."""

import ast
import json

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference.model import ReferenceModel, decode
from portbench.reference.nms import nms_image
from portbench.scenes import scene_pool
from portbench.weights import draw_state_dict

FORBIDDEN = set(harness.FORBIDDEN) | {"multispectral_object_detection_tpu_torch"}
YARDSTICK = ["reference/model.py", "reference/nms.py", "weights.py",
             "scenes.py", "work.py", "seeds.py"]


def small_cfg(name="cft-l-llvip-640"):
    cfg = json.loads((harness.HERE / "configs" / f"{name}.json").read_text())
    return dict(cfg, depth_multiple=0.33, width_multiple=0.25, canvas=64,
                frame_hw=[48, 64])


@pytest.mark.parametrize("path", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(path):
    tree = ast.parse((harness.HERE / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops = [node.module.split(".")[0]]
        else:
            continue
        assert not set(tops) & FORBIDDEN, (path, tops)


def test_state_dict_fits_the_port_and_is_seeded():
    from multispectral_object_detection_tpu_torch.models.model import (
        build_model)

    cfg = small_cfg()
    model_cfg = {k: cfg[k] for k in harness.MODEL_KEYS}
    sd = draw_state_dict(cfg, 7, "cpu")
    port = build_model(model_cfg, device="meta").state_dict()
    want = {k for k, v in port.items() if v.is_floating_point()
            and not k.endswith(("anchors", "anchor_grid"))}
    assert set(sd) == want
    for k in sd:
        assert sd[k].shape == port[k].shape
    again = draw_state_dict(cfg, 7, "cpu")
    other = draw_state_dict(cfg, 8, "cpu")
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["model.0.conv.conv.weight"],
                           other["model.0.conv.conv.weight"])


@pytest.mark.parametrize("name", ["cft-l-llvip-640", "cft-x-llvip-1024"])
def test_reference_matches_the_port_in_fp32(name):
    from multispectral_object_detection_tpu_torch.hub import Detector

    cfg = small_cfg(name)
    model_cfg = {k: cfg[k] for k in harness.MODEL_KEYS}
    sd = draw_state_dict(cfg, 5, "cpu")
    det = Detector(cfg=model_cfg, state_dict=sd, img_size=64, conf=0.25,
                   iou=0.45, dtype=torch.float32, device="cpu")
    ref = ReferenceModel(model_cfg)
    ref.load_state_dict(sd)
    ref.eval()
    rgb, ir, _ = scene_pool(5, 1, 2, (64, 64), cfg["frame_hw"], 1, 5,
                            "cpu")[0]
    prog = det.raw(rgb, ir)
    x, x2 = (torch.from_numpy(t).permute(0, 3, 1, 2).float() / 255
             for t in (rgb, ir))
    with torch.no_grad():
        want = ref(x, x2)
    for p, r in zip(prog, want):
        assert p.shape == r.shape
        assert (p - r).abs().max() <= 1e-4 * r.abs().max()
    # decode and NMS: the reference's on the port's own raw outputs
    dets = det.infer(rgb, ir)
    pred = decode(prog, ref.anchors, ref.strides).numpy()
    for i in range(len(pred)):
        b, s, c = nms_image(pred[i], 0.25, 0.45, 300, 1024)
        v = dets.valid[i].numpy()
        assert len(b) == v.sum() > 0
        np.testing.assert_allclose(dets.boxes[i].numpy()[v], b, atol=1e-3)
        np.testing.assert_allclose(dets.scores[i].numpy()[v], s, atol=1e-6)
