"""PyTorch port, the evaluation path end to end against the JAX package on
the mini n-scale two-stream CFT model (nc=2, 64 px, fp32, random weights
from a seed): the eval forwards (single and every ensemble mode) within
1e-4 relative of the JAX eval forward (BN folded, as the JAX CLI runs it;
the TTA forward is the JAX-pinned ``tta_forward`` of tests/test_torch_c3.py
on the inputs / 255), and the two test CLIs on one JAX checkpoint
directory and one synthetic PNG set: mAP50 and mAP within 0.1 pt (the
eval-parity bar of PARITY_synthetic.md), default and ``--save-hybrid``,
and the ``--save-txt --save-conf`` files line for line to 1e-4, and
``--compute-loss``'s val loss within 1e-5 relative; ``--plots`` (the
confusion matrix and curves; without matplotlib an exit before any work)
and ``--wandb`` (a fake wandb module; without one a warning). Also the
CLI's guards: no GPU without ``--device cpu`` and the single-checkpoint
flags."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from multispectral_object_detection_tpu.cli.test_cli import main as jax_main
from multispectral_object_detection_tpu.ops import ds_fusion as jds
from multispectral_object_detection_tpu_torch import hub
from multispectral_object_detection_tpu_torch.cli import test_cli
from multispectral_object_detection_tpu_torch.data.imageio import write_png
from multispectral_object_detection_tpu_torch.data.synthetic import (
    make_paired_dataset)
from multispectral_object_detection_tpu_torch.models import configs
from multispectral_object_detection_tpu_torch.train import eval_forward
from multispectral_object_detection_tpu_torch.train.tta import tta_forward
from tests._torch_port import (  # noqa: F401
    jax_fused_forward, mini_single_weights, mini_weights,
    share_torch_threads, write_jax_checkpoint)

CFG, NC, IMG = "yolov5n_fusion_transformerx3", 2, 64
TOL = 1e-4  # fp32 forwards: max |port - jax| / max |jax|


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """Two JAX checkpoint directories (stripped ``model.msgpack``) of
    seeded random weights and a synthetic set of 8 PNG pairs."""
    root = tmp_path_factory.mktemp("evalcli")
    cfg = configs.get_config(CFG, nc=NC)
    members = [mini_weights(seed) for seed in (0, 1)]
    assert all(m["cfg"] == cfg for m in members)
    ckpts = [write_jax_checkpoint(root / f"ckpt{i}", m["params"], m["stats"])
             for i, m in enumerate(members)]
    rgb, ir = make_paired_dataset(str(root / "data"), n_images=8,
                                  img_size=IMG, nc=NC, seed=5)
    data = {"train_rgb": rgb, "train_ir": ir, "val_rgb": rgb, "val_ir": ir,
            "nc": NC, "names": ["red", "blue"]}
    data_yaml = root / "synth.yaml"
    data_yaml.write_text(yaml.safe_dump(data))
    # a listing of the first 4 pairs, for the runs that check paths only
    small = dict(data)
    for side, d in (("rgb", rgb), ("ir", ir)):
        listing = root / f"val4_{side}.txt"
        listing.write_text("\n".join(sorted(str(f) for f in Path(d).glob(
            "*.png"))[:4]) + "\n")
        small[f"val_{side}"] = str(listing)
    return dict(root=root, cfg=cfg, members=members, ckpts=ckpts, data=data,
                small=small, data_yaml=str(data_yaml))


def _common(ws, name):
    return ["--cfg", CFG, "--batch-size", "4", "--img-size", str(IMG),
            "--fp32", "--project", str(ws["root"] / "runs"), "--name", name]


def _port(ws, argv, data=None):
    args = test_cli.parse_args(["--device", "cpu", "--data",
                                ws["data_yaml"]] + argv)
    if data is not None:
        args.data = data  # a dict, as chip_smoke.py passes it
    return test_cli.run(args)


@pytest.mark.parametrize("hybrid", [False, True])
def test_test_clis_agree_on_one_checkpoint(ws, hybrid):
    extra = ["--save-hybrid"] if hybrid else ["--save-txt", "--save-conf",
                                               "--compute-loss"]
    name = "hyb" if hybrid else "val"
    want = jax_main(_common(ws, f"jax_{name}") + [
        "--data", ws["data_yaml"], "--weights", ws["ckpts"][0]] + extra)
    got = _port(ws, _common(ws, f"port_{name}") + ["--weights",
                                                   ws["ckpts"][0]] + extra,
                data=ws["data"] if hybrid else None)
    assert got["seen"] == want["seen"] == 8
    for k in ("map50", "map"):
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])
    if hybrid:  # the ground truth, injected at confidence 1, finds itself
        assert got["map50"] > 0.95 and got["map"] > 0.95
        return
    # the val loss with the trainer's gains. 1e-2: the JAX CLI jits its
    # loss, and XLA's fused program gives this set's second batch a box
    # loss 0.5 % off the same JAX loss run op by op, which the port matches
    # within 1e-7 (test_val_loss_matches_jax_evaluate holds it to 1e-5)
    assert len(got["val_loss"]) == 3
    for g, w in zip(got["val_loss"], want["val_loss"]):
        assert abs(g - w) <= 1e-2 * abs(w), (got["val_loss"], w)
    jdir = ws["root"] / "runs" / "jax_val" / "labels"
    tdir = ws["root"] / "runs" / "port_val" / "labels"
    files = sorted(p.name for p in jdir.glob("*.txt"))
    assert files == sorted(p.name for p in tdir.glob("*.txt"))
    assert len(files) == 8
    n_lines = 0
    for f in files:
        a = [np.float64(ln.split()) for ln in (tdir / f).read_text().splitlines()]
        b = [np.float64(ln.split()) for ln in (jdir / f).read_text().splitlines()]
        assert len(a) == len(b), f
        # line for line, up to the order of lines whose scores tie within
        # the precision of the two frameworks' sums
        unused = list(range(len(b)))
        for row in a:
            hit = next((j for j in unused if len(b[j]) == 6 == len(row)
                        and b[j][0] == row[0] and np.allclose(
                            row[1:], b[j][1:], rtol=1e-4, atol=1e-4)), None)
            assert hit is not None, (f, row)
            unused.remove(hit)
        n_lines += len(a)
    assert n_lines > 0


def test_val_loss_matches_jax_evaluate(ws):
    """``evaluate(loss_fn=...)`` of both packages on the mini set (square
    batches, the fused forward), the JAX loss run op by op (its
    ``evaluate`` caches a jitted copy on ``loss_fn._jitted``; preset here
    to the plain call): within 1e-5 relative, fp32 sums of the same
    terms."""
    from multispectral_object_detection_tpu.data import datasets as jdata
    from multispectral_object_detection_tpu.train.evaluator import (
        evaluate as jax_evaluate)
    from multispectral_object_detection_tpu.train.loss import (
        DetectionLoss as JaxLoss)
    from multispectral_object_detection_tpu.train.loss import LossHyp
    from multispectral_object_detection_tpu.train.loss import (
        scale_gains as jax_gains)
    from multispectral_object_detection_tpu_torch.data import datasets
    from multispectral_object_detection_tpu_torch.models.detect import (
        anchor_arrays)
    from multispectral_object_detection_tpu_torch.train import evaluator
    from multispectral_object_detection_tpu_torch.train import loss as tloss

    d = ws["data"]
    jds = jdata.PairedDetectionDataset.from_sources(
        d["val_rgb"], d["val_ir"], img_size=IMG, nc=NC)
    tds = datasets.PairedDetectionDataset.from_sources(
        d["val_rgb"], d["val_ir"], img_size=IMG, nc=NC)
    model = hub.create(ws["cfg"], NC, weights=ws["ckpts"][0],
                       dtype=torch.float32, device="cpu")
    anchors, strides = anchor_arrays(model.spec.anchors), model.spec.strides
    jloss = JaxLoss(NC, anchors, strides, jax_gains(LossHyp(), NC, IMG, 3))
    jloss._jitted = jloss.__call__
    jf = jax_fused_forward()

    def jfwd(params, stats, rgb, ir):
        raw, dets = jf(params, rgb, ir)
        return dets, raw

    # batches of 2: the JAX forward's compiled shape of fwd_inputs
    want = jax_evaluate(jfwd, ws["members"][0]["fparams"], {},
                        jdata.BatchLoader(jds, 2, shuffle=False,
                                          drop_last=False), NC,
                        loss_fn=jloss)
    tl = tloss.DetectionLoss(NC, anchors, strides, tloss.scale_gains(
        tloss.LossHyp(), NC, IMG, 3))
    got = evaluator.evaluate(eval_forward.make_eval_forward(model),
                             datasets.BatchLoader(tds, 2), NC, device="cpu",
                             loss_fn=tl)
    for g, w in zip(got["val_loss"], want["val_loss"]):
        assert abs(g - w) <= 1e-5 * abs(w), (got["val_loss"],
                                             want["val_loss"])


def test_port_cli_ensembles_tta_int8_speed_and_coco(ws, tmp_path):
    """The port's CLI paths that the parity test above does not take, run
    on the CPU over 4 of the images (a listing file): finite metrics."""
    # fewer candidates than the eval protocol's conf 0.001: these runs
    # check the paths, not the protocol
    base = _common(ws, "more") + ["--weights", ws["ckpts"][0],
                                  "--conf-thres", "0.1"]
    two = _common(ws, "ens") + ["--weights"] + ws["ckpts"] + [
        "--conf-thres", "0.1"]
    runs = [base + ["--augment", "--no-fuse"],
            base + ["--int8", "--no-rect", "--save-coco",
                    str(tmp_path / "c.json"), "--save-json",
                    str(tmp_path / "r.json")],
            two + ["--ensemble-mode", "ds-sun"]]
    for argv in runs:
        r = _port(ws, argv, data=ws["small"])
        assert r["seen"] == 4 and np.isfinite([r["map50"], r["map"]]).all()
        if "--save-coco" in argv:
            assert set(r["coco"]) == {"AP", "AP50", "AP75"}
    assert (tmp_path / "c.json").is_file() and (tmp_path / "r.json").is_file()
    speed = _port(ws, base + ["--task", "speed", "--batch-size", "1"],
                  data=ws["small"])
    assert speed["ms_per_image"] > 0


@pytest.fixture(scope="module")
def fwd_inputs(ws):
    """The two members through the JAX eval forward (BN folded, as the JAX
    CLI runs it) and through the port's models read from the checkpoint
    directories."""
    rng = np.random.default_rng(1)
    rgb, ir = (rng.integers(0, 256, (2, IMG, IMG, 3), dtype=np.uint8)
               for _ in range(2))
    jf = jax_fused_forward()
    members = [np.asarray(jf(m["fparams"], rgb, ir)[1])
               for m in ws["members"]]
    models = [hub.create(ws["cfg"], NC, weights=c, dtype=torch.float32,
                         device="cpu") for c in ws["ckpts"]]
    return dict(models=models, members=members,
                t=(torch.from_numpy(rgb), torch.from_numpy(ir)))


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= TOL, err


def test_eval_forward_matches_jax(fwd_inputs):
    f = fwd_inputs
    for model, want in zip(f["models"], f["members"]):
        got, raw = eval_forward.make_eval_forward(model)(*f["t"])
        assert len(raw) == 3
        _close(got, want)


@pytest.mark.parametrize("mode", eval_forward.ENSEMBLE_MODES)
def test_eval_forward_ensemble_matches_jax(fwd_inputs, mode):
    """Against the combination step of the JAX ensemble forward (what
    follows its vmap over the members) on the JAX members' outputs."""
    f = fwd_inputs
    got, none = eval_forward.make_eval_forward_ensemble(f["models"], mode)(
        *f["t"])
    assert none is None
    m = jnp.asarray(np.stack(f["members"]))                # (E, B, N, no)
    e, b, n, no = m.shape
    want = {"cat": lambda: jnp.moveaxis(m, 0, 1).reshape(b, e * n, no),
            "mean": lambda: m.mean(axis=0), "max": lambda: m.max(axis=0)}.get(
        mode, lambda: jds.fuse_detections_jit(
            m, method={"ds": "plain", "ds-li": "li", "ds-sun": "sun"}[mode]))()
    _close(got, want)


def test_eval_forward_tta_is_tta_forward_of_the_scaled_inputs(fwd_inputs):
    f = fwd_inputs
    model = f["models"][0]
    rgb, ir = (t[:1] for t in f["t"])
    got, none = eval_forward.make_eval_forward_tta(model)(rgb, ir)
    x, x2 = (t.permute(0, 3, 1, 2).float() / 255.0 for t in (rgb, ir))
    with torch.inference_mode():
        want = tta_forward(model, x, x2)
    assert none is None and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_hub_ensemble_and_results(ws):
    ens = hub.Ensemble([(ws["cfg"], c) for c in ws["ckpts"]], nc=NC,
                       mode="max", device="cpu")
    x = np.random.default_rng(0).random((1, IMG, IMG, 3), np.float32)
    out = ens.decode_all(x, x)
    assert out.shape == (1, 3 * sum((IMG // s) ** 2 for s in (8, 16, 32)),
                         5 + NC) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="unknown ensemble mode"):
        hub.Ensemble([(ws["cfg"], None)], nc=NC, mode="bogus", device="cpu")
    res = hub.DetectionResults([np.array([[1.0, 2, 3, 4]])],
                               [np.array([0.5])], [np.array([1])],
                               ["red", "blue"])
    frame = res.pandas()[0]
    assert len(res) == 1 and frame["name"].tolist() == ["blue"]


def test_cli_without_gpu_and_without_device_cpu_prints_no_metric(
        ws, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    rc = test_cli.main(["--data", ws["data_yaml"], "--weights",
                        ws["ckpts"][0], "--cfg", CFG])
    out = capsys.readouterr()
    assert rc != 0 and "CUDA" in out.err
    assert out.out == "" and "mAP" not in out.err


def test_plots_write_the_confusion_matrix_and_the_curves(ws):
    # --save-hybrid: the ground truth among the candidates gives curves
    res = _port(ws, _common(ws, "plots") + ["--weights", ws["ckpts"][0],
                                            "--plots", "--save-hybrid"],
                data=ws["small"])
    run = ws["root"] / "runs" / "plots"
    for f in ("confusion_matrix.png", "PR_curve.png", "F1_curve.png",
              "P_curve.png", "R_curve.png"):
        assert (run / f).stat().st_size > 0, f
    cv = res["curves"]
    assert cv["px"].shape == (1000,) and cv["f1"].shape[1] == 1000


def test_plots_without_matplotlib_exit_before_any_work(ws, monkeypatch):
    from multispectral_object_detection_tpu_torch.utils import plots

    monkeypatch.setattr(plots, "available", lambda: False)
    with pytest.raises(SystemExit, match="--plots needs matplotlib"):
        _port(ws, _common(ws, "noplots") + ["--weights", "missing.pt",
                                            "--plots"])
    assert not (ws["root"] / "runs" / "noplots").exists()


def test_wandb_logs_the_metrics_and_16_panels(ws, monkeypatch):
    from tests._torch_port import install_fake_wandb

    run = install_fake_wandb(monkeypatch)
    res = _port(ws, _common(ws, "wandb") + ["--weights", ws["ckpts"][0],
                                            "--wandb", "--entity", "me"])
    assert run.init_kw["entity"] == "me" and run.finished
    panels = [p for p, _ in run.logged if "Bounding Box Debugger/Images" in p]
    assert len(panels) == 1 and len(panels[0][
        "Bounding Box Debugger/Images"]) == 8  # every val image (< 16)
    metrics = [p for p, _ in run.logged if "metrics/mAP_0.5" in p][0]
    assert metrics["metrics/mAP_0.5"] == res["map50"]


def test_wandb_without_the_package_warns_and_finishes(ws, monkeypatch,
                                                      caplog):
    import sys

    monkeypatch.setitem(sys.modules, "wandb", None)  # import fails
    res = _port(ws, _common(ws, "nowandb") + ["--weights", ws["ckpts"][0],
                                              "--wandb"], data=ws["small"])
    assert "wandb unavailable" in caplog.text and res["seen"] == 4


@pytest.mark.parametrize("flag", ["--augment", "--int8", "--compute-loss"])
def test_single_checkpoint_flags_refuse_an_ensemble(ws, flag):
    with pytest.raises(SystemExit, match="single-checkpoint"):
        _port(ws, ["--weights"] + ws["ckpts"] + [flag])


def _index_coded_set(root: Path, n: int = 8):
    """n PNG pairs, the first half portrait (64x48), the rest landscape
    (48x64); image k is the constant 20k + 10 and holds one label of class
    k. Under rect batches the loader serves them in aspect order."""
    for side in ("rgb", "ir"):
        (root / side / "images").mkdir(parents=True)
        (root / side / "labels").mkdir(parents=True)
    for k in range(n):
        hw = (64, 48) if k < n // 2 else (48, 64)
        for side in ("rgb", "ir"):
            write_png(root / side / "images" / f"{k:06d}.png",
                      np.full(hw + (3,), 20 * k + 10, np.uint8))
            (root / side / "labels" / f"{k:06d}.txt").write_text(
                f"{k} 0.5 0.5 1 1\n")
    return {"val_rgb": str(root / "rgb" / "images"),
            "val_ir": str(root / "ir" / "images"), "nc": n,
            "names": [str(k) for k in range(n)]}


def _index_coded_forward(rgb, ir):
    """One full-canvas candidate per image whose class is read from the
    image's pixel value (20k + 10 -> k)."""
    B, H, W = rgb.shape[:3]
    k = (rgb[:, H // 2, W // 2, 0].long() - 10) // 20
    det = torch.zeros(B, 1, 5 + 8)
    det[:, 0, :5] = torch.tensor([W / 2, H / 2, W, H, 1.0])
    det[torch.arange(B), 0, 5 + k] = 1.0
    return det, None


@pytest.mark.parametrize("rect", [True, False])
def test_saved_txt_files_and_json_ids_follow_the_dataset_order(
        tmp_path, monkeypatch, rect):
    """Rect batches (the default) serve 4 landscape before 4 portrait
    pairs: each txt file and COCO record still belongs to its own image,
    with its own native size."""
    data = _index_coded_set(tmp_path / "data")
    monkeypatch.setattr(test_cli, "build_forward",
                        lambda *a: (None, _index_coded_forward))
    args = test_cli.parse_args(
        ["--device", "cpu", "--data", "dict", "--weights", "none",
         "--img-size", "64", "--batch-size", "4", "--save-txt",
         "--save-coco", str(tmp_path / "coco.json"), "--project",
         str(tmp_path / "runs"), "--name", "x"]
        + ([] if rect else ["--no-rect"]))
    args.data = data
    order = []
    real_loader = test_cli.make_loader

    def loader_spy(*a):
        ds, loader = real_loader(*a)
        order.extend(np.concatenate(loader._batches()).tolist())
        return ds, loader

    monkeypatch.setattr(test_cli, "make_loader", loader_spy)
    res = test_cli.run(args)
    assert res["seen"] == 8 and res["map50"] > 0.99
    assert (order != list(range(8))) == rect  # rect reorders the images
    for k in range(8):
        lines = (tmp_path / "runs" / "x" / "labels" /
                 f"{k:06d}.txt").read_text().split()
        assert lines == [str(k), "0.5", "0.5", "1", "1"], (k, lines)
    records = json.loads((tmp_path / "coco.json").read_text())
    assert sorted(r["image_id"] for r in records) == list(range(8))
    for r in records:
        k = r["image_id"]
        w0, h0 = (48, 64) if k < 4 else (64, 48)
        assert r["category_id"] == k and r["bbox"] == [0, 0, w0, h0], r
    assert res["coco"]["AP"] > 0.99


def test_tta_forward_single_stream_matches_jax():
    """A single-stream model through the port's TTA against JAX's
    ``tta_forward(..., ir=None)`` on the same weights: max |port - jax| /
    max |jax| <= TOL (fp32)."""
    import jax

    from multispectral_object_detection_tpu.models import (
        build_model as jax_build)
    from multispectral_object_detection_tpu.train.tta import (
        tta_forward as jax_tta)

    m = mini_single_weights(0)
    rgb = np.random.default_rng(3).integers(0, 256, (2, IMG, IMG, 3),
                                            dtype=np.uint8)
    jmodel = jax_build(m["cfg"])
    want = jax.jit(lambda p, s, x: jax_tta(jmodel, p, s, x / 255.0))(
        m["params"], m["stats"], rgb.astype(np.float32))
    model = hub.create(m["cfg"], 2, state_dict=m["sd"], dtype=torch.float32,
                       device="cpu")
    got, none = eval_forward.make_eval_forward_tta(model)(
        torch.from_numpy(rgb), torch.from_numpy(rgb))
    assert none is None
    _close(got, want)


def test_port_cli_augment_on_a_single_stream_model(ws, tmp_path):
    """``--augment`` on a single-stream config and data without an IR
    side."""
    m = mini_single_weights(0)
    ckpt = write_jax_checkpoint(tmp_path / "ck", m["params"], m["stats"])
    args = test_cli.parse_args(
        ["--device", "cpu", "--data", "dict", "--cfg", "yolov5n",
         "--weights", ckpt, "--img-size", str(IMG), "--batch-size", "4",
         "--fp32", "--augment", "--conf-thres", "0.1", "--project",
         str(tmp_path / "runs")])
    args.data = {"val": ws["small"]["val_rgb"], "nc": NC}
    r = test_cli.run(args)
    assert r["seen"] == 4 and np.isfinite([r["map50"], r["map"]]).all()
