"""PyTorch port, whole slice: configs, parser, parameter counts, the weight
bridge, and a mini two-stream CFT model (n scale, nc=2, 64 px) against the
JAX package on the same weights: raw head outputs unfused and BN-folded,
decoded predictions, and ``Detector.infer`` against the bench-style JAX
pipeline (folded BN, Pallas CFT stack in interpret mode, decode, NMS)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multispectral_object_detection_tpu.models import build_model as jax_build
from multispectral_object_detection_tpu.models import configs as jconfigs
from multispectral_object_detection_tpu.models.parser import (
    parse_model_config as jax_parse)
from multispectral_object_detection_tpu.ops.nms import (
    batched_nms as jax_batched_nms)
from multispectral_object_detection_tpu.utils.torch_import import (
    convert_state_dict)
from multispectral_object_detection_tpu_torch.hub import Detector
from multispectral_object_detection_tpu_torch.models import configs
from multispectral_object_detection_tpu_torch.models.model import (
    build_model, load_reference_state_dict)
from multispectral_object_detection_tpu_torch.models.parser import (
    parse_model_config)
from multispectral_object_detection_tpu_torch.utils.jax_import import (
    state_dict_from_jax)
from tests._torch_port import (  # noqa: F401
    jax_fused_forward, mini_weights, share_torch_threads, to_nchw)

IMG, NC, CONF = 64, 2, 0.3


@pytest.mark.parametrize("name", ["yolov5s", "yolov5n", "yolov5l_fusion_add",
                                  "yolov5n_fusion_transformer",
                                  "yolov5l_fusion_transformerx3"])
def test_configs_and_specs_match_jax(name):
    cfg = configs.get_config(name, nc=3)
    assert cfg == jconfigs.get_config(name, nc=3)
    assert dataclasses.asdict(parse_model_config(cfg)) == \
        dataclasses.asdict(jax_parse(cfg))


@pytest.mark.parametrize("cfg,count", [
    (("l", "transformerx3"), 206_247_222),
    (("l", "transformer"), 207_850_038),
    (("s", None), 7_276_605),
])
def test_param_count_on_meta_matches_reference(cfg, count):
    scale, fusion = cfg
    dsl = (configs.yolov5(scale) if fusion is None else
           configs.yolov5_two_stream(scale, nc=1, fusion=fusion))
    model = build_model(dsl, device="meta")
    assert sum(p.numel() for p in model.parameters()) == count


@pytest.fixture(scope="module")
def mini():
    """Port model with random weights, the same weights as JAX trees, a
    uint8 batch, and the JAX outputs (computed once per module)."""
    w = mini_weights(0)
    cfg, sd, params, stats = w["cfg"], w["sd"], w["params"], w["stats"]
    assert cfg == configs.yolov5_two_stream("n", nc=NC, fusion="transformerx3")
    port = build_model(cfg)
    load_reference_state_dict(port, sd)
    rng = np.random.default_rng(1)
    rgb, ir = (rng.integers(0, 256, (2, IMG, IMG, 3), dtype=np.uint8)
               for _ in range(2))
    x, x2 = (jnp.asarray(a, jnp.float32) / 255.0 for a in (rgb, ir))

    jmodel = jax_build(cfg)
    raw = jax.jit(lambda p, s: jmodel.apply(
        {"params": p, "batch_stats": s}, x, x2, train=False))(params, stats)
    fraw, dets = jax_fused_forward()(w["fparams"], rgb, ir)
    nms = jax_batched_nms(dets, conf_thres=CONF, iou_thres=0.45,
                          multi_label=False, max_det=300, top_k=1024)
    return dict(cfg=cfg, port=port, sd=sd, params=params, stats=stats,
                rgb=rgb, ir=ir, raw=[np.asarray(r) for r in raw],
                fraw=[np.asarray(r) for r in fraw], dets=np.asarray(dets),
                nms=jax.tree.map(np.asarray, nms))


def _port_raw(model, rgb, ir):
    x, x2 = (to_nchw(a).float() / 255.0 for a in (rgb, ir))
    with torch.no_grad():
        return model(x.contiguous(memory_format=torch.channels_last),
                     x2.contiguous(memory_format=torch.channels_last))


def test_bridge_round_trips(mini):
    sd = state_dict_from_jax(mini["params"], mini["stats"])
    want = {k: v for k, v in mini["sd"].items()
            if not k.endswith("num_batches_tracked")}
    assert sorted(sd) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(sd[k], want[k], err_msg=k)
    p, s = convert_state_dict(sd)
    assert jax.tree.structure(p) == jax.tree.structure(mini["params"])
    assert jax.tree.structure(s) == jax.tree.structure(mini["stats"])
    for a, b in zip(jax.tree.leaves((p, s)),
                    jax.tree.leaves((mini["params"], mini["stats"]))):
        np.testing.assert_array_equal(a, b)


def test_unfused_raw_outputs_match_jax(mini):
    got = _port_raw(mini["port"], mini["rgb"], mini["ir"])
    for g, w in zip(got, mini["raw"]):
        assert g.shape == w.shape  # (B, ny, nx, na, 5+nc)
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def fused_port(mini):
    model = build_model(mini["cfg"])
    load_reference_state_dict(
        model, state_dict_from_jax(mini["params"], mini["stats"]))
    return model.fuse()


def test_fused_raw_outputs_match_jax_bench_path(mini, fused_port):
    got = _port_raw(fused_port, mini["rgb"], mini["ir"])
    for g, w in zip(got, mini["fraw"]):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-4)


def test_decoded_predictions_match_jax(mini, fused_port):
    got = fused_port.decode(_port_raw(fused_port, mini["rgb"], mini["ir"]))
    assert got.shape == mini["dets"].shape
    np.testing.assert_allclose(got.numpy(), mini["dets"], rtol=2e-4,
                               atol=2e-3)


def test_detector_infer_matches_jax_bench_infer(mini):
    det = Detector(mini["cfg"], nc=NC, img_size=IMG, conf=CONF,
                   dtype=torch.float32, device="cpu",
                   state_dict=state_dict_from_jax(mini["params"],
                                                  mini["stats"]))
    got = det.infer(mini["rgb"], mini["ir"])
    want = mini["nms"]
    assert got.boxes.shape == (2, 300, 4)
    assert int(got.valid.sum()) > 0
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.classes.numpy(), want.classes)
    np.testing.assert_allclose(got.scores.numpy(), want.scores, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got.boxes.numpy(), want.boxes, rtol=1e-4,
                               atol=2e-3)


def test_detector_bf16_on_cpu_tracks_fp32(mini):
    """The bf16 serving form (params cast, LN/BN kept fp32) on the CPU:
    finite and within bf16 noise of the fp32 model."""
    kw = dict(nc=NC, img_size=IMG, device="cpu", state_dict=mini["sd"])
    raw16 = Detector(mini["cfg"], dtype=torch.bfloat16, **kw).raw(
        mini["rgb"], mini["ir"])
    raw32 = Detector(mini["cfg"], dtype=torch.float32, **kw).raw(
        mini["rgb"], mini["ir"])
    for a, b in zip(raw16, raw32):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a.float()).all()
        assert (a.float() - b).abs().max() <= 0.1 * b.abs().max()
