"""PyTorch port, export (cli/export_cli.py) on the CPU: the CLI's
``torch.export`` program, saved and loaded, equals the eager forward on
the mini two-stream CFT model (fp32); the ``--with-nms`` program equals the
eager NMS; the fixed-trip NMS it traces equals ``batched_nms``'s
early-exit form; the manifest has the JAX export's keys (and says that the
program carries the plain CFT stack); the jax2tf formats and a missing GPU
exit."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from multispectral_object_detection_tpu_torch.cli import export_cli
from multispectral_object_detection_tpu_torch.hub import create
from multispectral_object_detection_tpu_torch.ops.nms import batched_nms
from tests._torch_port import (  # noqa: F401
    mini_single_weights, mini_weights, share_torch_threads,
    write_jax_checkpoint)

CFG, NC, IMG = "yolov5n_fusion_transformerx3", 2, 64


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("export")
    path = root / "mini.pt"
    torch.save({k: torch.from_numpy(np.asarray(v))
                for k, v in mini_weights(0)["sd"].items()}, path)
    return str(path)


def _inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randint(0, 256, (1, IMG, IMG, 3), dtype=torch.uint8,
                               generator=g) for _ in range(2))


def test_cli_program_round_trips_to_the_eager_forward(ckpt, tmp_path):
    out = tmp_path / "e"
    assert export_cli.main([
        "--weights", ckpt, "--cfg", CFG, "--nc", str(NC), "--img-size",
        str(IMG), "--fp32", "--device", "cpu", "--out", str(out), "--grid",
        "--dynamic", "--simplify"]) == 0
    program = torch.export.load(str(out / "model.pt2")).module()
    model = create(CFG, NC, weights=ckpt, dtype=torch.float32, device="cpu")
    rgb, ir = _inputs()
    with torch.no_grad():
        want = export_cli.ExportForward(model, False)(rgb, ir)
    got = program(rgb, ir)
    assert got.shape == (1, 3 * (8 * 8 + 4 * 4 + 2 * 2), 5 + NC)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["input"] == {"shape": [1, IMG, IMG, 3], "dtype": "uint8",
                                 "order": ["rgb", "ir"]}
    assert manifest["strides"] == [8, 16, 32] and not manifest["with_nms"]
    assert manifest["platforms"] == ["cpu"]
    assert "plain" in manifest["cft_stack"]


def test_nms_program_equals_the_eager_nms(ckpt, monkeypatch):
    """At max_det 20 (300 in the CLI) to keep the traced loop short."""
    monkeypatch.setitem(export_cli.NMS_KW, "max_det", 20)
    monkeypatch.setitem(export_cli.NMS_KW, "conf_thres", 0.01)
    model = create(CFG, NC, weights=ckpt, dtype=torch.float32, device="cpu")
    program = export_cli.export(model, 1, IMG, True,
                                torch.device("cpu")).module()
    rgb, ir = _inputs(1)
    got = program(rgb, ir)
    with torch.no_grad():
        dets = export_cli.ExportForward(model, False)(rgb, ir)
    kw = dict(export_cli.NMS_KW)
    want = batched_nms(dets, **kw)
    assert int(want.valid.sum()) > 0
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed,multi_label,agnostic,max_det", [
    (0, False, False, 300), (1, True, False, 50), (2, False, True, 30),
    (3, True, True, 300)])
def test_fixed_trip_nms_equals_the_early_exit(seed, multi_label, agnostic,
                                              max_det):
    """Clustered random boxes, several images (one without candidates)."""
    g = torch.Generator().manual_seed(seed)
    b, n, nc = 3, 400, 4
    centres = torch.rand(b, 12, 2, generator=g) * 200
    xy = centres[:, torch.randint(0, 12, (n,), generator=g)] + \
        torch.randn(b, n, 2, generator=g) * 6
    wh = 10 + torch.rand(b, n, 2, generator=g) * 30
    scores = torch.rand(b, n, 1 + nc, generator=g)
    scores[2, :, 0] = 0.0  # image 2: no candidates
    pred = torch.cat([xy, wh, scores], -1)
    kw = dict(conf_thres=0.2, iou_thres=0.45, multi_label=multi_label,
              agnostic=agnostic, max_det=max_det, top_k=1024)
    want = batched_nms(pred, **kw)
    got = batched_nms(pred, fixed_trip=True, **kw)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert int(want.valid[:2].sum()) > 0 and not want.valid[2].any()


def test_manifest_has_the_jax_keys(tmp_path, monkeypatch):
    from multispectral_object_detection_tpu.cli import export_cli as jcli

    monkeypatch.setenv("MT_NO_COMPILATION_CACHE", "1")
    w = mini_single_weights(0)
    jdir = write_jax_checkpoint(tmp_path / "jax", w["params"], w["stats"])
    argv = ["--cfg", "yolov5n", "--nc", "2", "--img-size", str(IMG),
            "--fp32", "--weights", jdir, "--device", "cpu"]
    want = json.loads((Path(jcli.run(jcli.parse_args(
        argv + ["--out", str(tmp_path / "j")]))) / "manifest.json")
        .read_text())
    got = json.loads((Path(export_cli.run(
        export_cli.parse_args(argv + ["--out", str(tmp_path / "p")])))
        / "manifest.json").read_text())
    assert set(got) == set(want) | {"cft_stack"}
    for k in want:
        assert got[k] == want[k], k


@pytest.mark.parametrize("flag", ["--saved-model", "--tflite"])
def test_jax_only_formats_exit(flag):
    args = export_cli.parse_args(["--weights", "unused", flag])
    with pytest.raises(SystemExit, match="JAX package"):
        export_cli.run(args)


def test_without_gpu_and_without_device_cpu_exits(ckpt, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert export_cli.main(["--weights", ckpt]) == 1
    assert "CUDA" in capsys.readouterr().err
