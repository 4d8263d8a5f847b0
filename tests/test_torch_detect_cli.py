"""PyTorch port, the detect CLI (cli/detect_cli.py) against the JAX detect
CLI on one JAX checkpoint directory of the mini n-scale two-stream CFT
model and one shared set of 4 synthetic 128-px PNG pairs (fp32, CPU): the
label files (``--save-txt --save-conf``) line for line, normalised
coordinates and confidences within 1e-4 (the forwards differ by fp32
summation order). The port's batched (``--batch-size 3``: a padded short
batch) and headless (``--nosave``) paths against its own batch-1 path
within 1e-6, the bound tests/test_detect_batched.py holds the JAX CLI to.
Then every other flag of the port's CLI once on the same set, ``--update``
stripping a training checkpoint, and the guards."""

from pathlib import Path

import numpy as np
import pytest
import torch

from multispectral_object_detection_tpu.cli.detect_cli import (
    main as jax_main)
from multispectral_object_detection_tpu_torch.cli import detect_cli
from multispectral_object_detection_tpu_torch.data.synthetic import (
    make_paired_dataset)
from multispectral_object_detection_tpu_torch.utils import general
from tests._torch_port import (  # noqa: F401
    mini_weights, share_torch_threads, write_jax_checkpoint)

CFG, NC, IMG = "yolov5n_fusion_transformerx3", 2, 128
CONF = "0.3"


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("detect")
    rgb, ir = make_paired_dataset(str(root / "data"), n_images=4,
                                  img_size=IMG, nc=NC, seed=5)
    ckpts = [write_jax_checkpoint(root / f"ck{s}", mini_weights(s)["params"],
                                  mini_weights(s)["stats"]) for s in (0, 1)]
    return dict(root=root, rgb=rgb, ir=ir, ckpts=ckpts)


def _argv(ws, name, extra, weights=None):
    return ["--cfg", CFG, "--nc", str(NC), "--source1", ws["rgb"],
            "--source2", ws["ir"], "--img-size", str(IMG), "--conf-thres",
            CONF, "--fp32", "--project", str(ws["root"] / "runs"), "--name",
            name, "--weights", *(weights or ws["ckpts"][:1])] + extra


def _port(ws, name, extra, weights=None):
    return detect_cli.run(detect_cli.parse_args(
        _argv(ws, name, extra, weights) + ["--device", "cpu"]))


def _labels(ws, name):
    d = ws["root"] / "runs" / name / "labels"
    return {f.name: np.loadtxt(f, ndmin=2) for f in sorted(d.glob("*.txt"))}


def test_label_files_match_the_jax_cli(ws):
    extra = ["--save-txt", "--save-conf", "--batch-size", "2"]
    want = jax_main(_argv(ws, "jax", extra))
    got = _port(ws, "port", extra)
    assert got["n_images"] == want["n_images"] == 4
    assert got["n_det"] == want["n_det"] > 0
    jl, tl = _labels(ws, "jax"), _labels(ws, "port")
    assert sorted(jl) == sorted(tl) and len(jl) == 4
    for f in jl:
        a, b = tl[f], jl[f]
        assert a.shape == b.shape, f
        unused = list(range(len(b)))
        for row in a:  # up to the order of scores tied within 1e-4
            hit = next((j for j in unused if b[j][0] == row[0] and
                        np.allclose(row[1:], b[j][1:], rtol=0, atol=1e-4)),
                       None)
            assert hit is not None, (f, row)
            unused.remove(hit)
    files = sorted(p.name for p in (ws["root"] / "runs" / "port").glob("*"))
    assert files == sorted(p.name for p in (ws["root"] / "runs" / "jax")
                           .glob("*")) and "000000_ir.jpg" in files


def test_batched_and_headless_match_batch1(ws):
    r1 = _port(ws, "b1", ["--save-txt"])
    r3 = _port(ws, "b3", ["--save-txt", "--batch-size", "3"])  # 3 + 1 padded
    rh = _port(ws, "hl", ["--save-txt", "--batch-size", "4", "--nosave"])
    assert r1["n_images"] == r3["n_images"] == rh["n_images"] == 4
    assert r1["n_det"] == r3["n_det"] == rh["n_det"] > 0
    assert r1["fps"] > 0 and rh["fps_steady"] > 0
    l1, l3, lh = (_labels(ws, n) for n in ("b1", "b3", "hl"))
    assert set(l1) == set(l3) == set(lh) and len(l1) == 4
    for k in l1:
        np.testing.assert_allclose(l1[k], l3[k], atol=1e-6)
        np.testing.assert_allclose(l1[k], lh[k], atol=1e-6)
    assert not list((ws["root"] / "runs" / "hl").glob("*.jpg"))


@pytest.mark.parametrize("extra,weights", [
    (["--save-crop", "--classes", "1", "--agnostic-nms", "--hide-labels",
      "--line-thickness", "3"], 1),
    (["--merge-nms", "--hide-conf", "--no-fuse"], 1),
    (["--augment"], 1),
    (["--int8", "--batch-size", "4", "--nosave"], 1),
] + [(["--ensemble-mode", m, "--nosave", "--batch-size", "4"], 2)
     for m in ("cat", "mean", "max", "ds", "ds-li", "ds-sun")])
def test_every_flag_runs(ws, extra, weights):
    name = "flags_" + "_".join(a.strip("-") for a in extra[:2])
    r = _port(ws, name, extra + ["--img-size", "64", "--save-txt",
                                 "--conf-thres", "0.1"],
              weights=ws["ckpts"][:weights])
    assert r["n_images"] == 4 and r["n_det"] > 0
    labels = _labels(ws, name)
    assert len(labels) == 4
    rows = np.concatenate([v for v in labels.values() if v.size])
    assert np.isfinite(rows).all() and (rows[:, 1:] >= 0).all()
    if "--classes" in extra:
        assert (rows[:, 0] == 1).all()
        crops = list((ws["root"] / "runs" / name / "crops" / "1").glob("*"))
        assert len(crops) == r["n_det"]


def test_images_are_png_without_cv2(ws, monkeypatch):
    monkeypatch.setattr(general, "_cv2", lambda: None)
    r = _port(ws, "nocv2", ["--img-size", "64"])
    out = sorted(p.name for p in Path(r["save_dir"]).glob("*"))
    assert out[:2] == ["000000_ir.png", "000000_rgb.png"] and len(out) == 8


def test_update_strips_a_checkpoint_directory(ws, tmp_path):
    """--update after the run: the port's training state (``state.pt``)
    becomes ``model.pt``, its EMA weights, which a second run reads to the
    same labels."""
    from multispectral_object_detection_tpu_torch.models.model import (
        build_model)
    from multispectral_object_detection_tpu_torch.train.optim import (
        OptHyp, build_optimizer)
    from multispectral_object_detection_tpu_torch.train.trainer import (
        TrainState)
    from multispectral_object_detection_tpu_torch.utils.checkpoint import (
        load_inference_params, save_checkpoint)

    w = mini_weights(0)
    model = build_model(w["cfg"])
    model.load_state_dict({k: torch.from_numpy(v) for k, v in w["sd"].items()})
    state = TrainState(model, build_optimizer(model, OptHyp(), 4, 3))
    ck = tmp_path / "last"
    save_checkpoint(ck, state, epoch=0, best_fitness=0.0)
    r = _port(ws, "upd", ["--save-txt", "--update"], weights=[str(ck)])
    assert (ck / "model.pt").is_file() and r["n_images"] == 4
    sd = load_inference_params(ck)
    for k, v in w["sd"].items():
        np.testing.assert_array_equal(sd[k], v)
    _port(ws, "upd2", ["--save-txt"], weights=[str(ck)])
    a, b = _labels(ws, "upd"), _labels(ws, "upd2")
    assert sorted(a) == sorted(b)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f])


def test_guards(ws, capsys):
    with pytest.raises(SystemExit, match="strips checkpoint directories"):
        _port(ws, "upd", ["--update"], weights=[str(ws["root"] / "w.pt")])
    with pytest.raises(SystemExit, match="single-checkpoint"):
        _port(ws, "ens", ["--int8"], weights=ws["ckpts"])
    if not torch.cuda.is_available():
        rc = detect_cli.main(_argv(ws, "gpu", ["--save-txt"]))
        out = capsys.readouterr()
        assert rc == 1 and "CUDA" in out.err
        assert not (ws["root"] / "runs" / "gpu").exists()
