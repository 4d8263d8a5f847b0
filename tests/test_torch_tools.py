"""PyTorch port, the tools (``multispectral_object_detection_tpu_torch.tools``)
on the CPU, against the JAX package's tools under ``tools/`` (loaded by
path; ``tools/mfu.py`` re-executes its process at import and is never
loaded): the train CLI's ``--bucket`` (accepted, logged, nothing
uploaded); ``load_flat_yaml`` against PyYAML on what ``dump_flat_yaml``
writes; ``autosplit``, ``flatten`` and ``extract_boxes`` on one synthetic
tree (the same files; crops through cv2 byte-equal, and without cv2 PNG
crops equal to their source regions); ``export_torch_ckpt`` on a pickled
stand-in of the reference's model class (its ``.npz`` equal to the JAX
tool's, its ``.pt`` giving the mini model's forward exactly);
``find_interrupted`` equal to the JAX tool's on a tree of runs, and a
real mini run of 2 epochs raised to 3 resumed at epoch 2 while a JAX
run and a run trained on a dict are skipped; the MFU arithmetic and the
peak lookup; the profile's grouping by kind and the profile tool on the
mini model."""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from multispectral_object_detection_tpu_torch.cli import train_cli
from multispectral_object_detection_tpu_torch.data.hyps import (
    HYP_FINETUNE, HYP_SCRATCH, dump_flat_yaml, load_flat_yaml, read_yaml)
from multispectral_object_detection_tpu_torch.data.imageio import imread
from multispectral_object_detection_tpu_torch.data.synthetic import (
    make_paired_dataset)
from multispectral_object_detection_tpu_torch.models import configs
from multispectral_object_detection_tpu_torch.models.model import (
    build_model, load_reference_state_dict)
from multispectral_object_detection_tpu_torch.tools import (
    dataset_tools, export_torch_ckpt, mfu, profile_model, resume_runs)
from multispectral_object_detection_tpu_torch.utils import plots
from multispectral_object_detection_tpu_torch.utils.checkpoint import (
    load_inference_params)
from multispectral_object_detection_tpu_torch.utils.profiling import (
    estimate_flops)
from tests._torch_port import (  # noqa: F401
    random_state_dict, share_torch_threads)

ROOT = Path(__file__).resolve().parents[1]
CFG, IMG = "yolov5n_fusion_transformerx3", 64


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------- F7, yaml
def test_train_cli_takes_bucket_and_uploads_nothing(tmp_path, caplog):
    caplog.set_level("INFO")
    args = train_cli.parse_args(["--data", "x", "--bucket", "gs://x",
                                 "--device", "cpu", "--project",
                                 str(tmp_path)])
    assert args.bucket == "gs://x"
    args.data = {"train_rgb": str(tmp_path / "none"),
                 "val_rgb": str(tmp_path / "none"), "nc": 1}
    with pytest.raises(FileNotFoundError):  # stops at the missing data
        train_cli.run(args)
    assert ("--bucket gs://x: gsutil upload unsupported; checkpoints stay "
            "local") in caplog.text
    assert train_cli.parse_args(["--data", "x"]).bucket == ""


def _opt_yaml_map() -> dict:
    args = train_cli.parse_args(["--data", "d.yaml", "--freeze", "model.0.",
                                 "--img-size", "64", "96", "--resume"])
    args.data = {"train_rgb": "a", "nc": 1}  # a dict, written as text
    return train_cli._flat(vars(args))


@pytest.mark.parametrize("d", [HYP_SCRATCH, HYP_FINETUNE, _opt_yaml_map()],
                         ids=["scratch", "finetune", "opt"])
def test_load_flat_yaml_equals_pyyaml_on_run_files(d):
    text = dump_flat_yaml(d)
    assert load_flat_yaml(text) == yaml.safe_load(text) == dict(d)


_SCALARS = (st.none() | st.booleans() | st.integers()
            | st.floats(allow_nan=False, allow_infinity=False)
            | st.text(st.characters(min_codepoint=32, max_codepoint=0x2fff,
                                    exclude_categories=("Cs", "Cc")),
                      max_size=12))


@settings(max_examples=30, deadline=None, database=None)
@given(st.dictionaries(st.text("abcxyz_", min_size=1, max_size=8),
                       _SCALARS | st.lists(_SCALARS, max_size=4),
                       min_size=1, max_size=6))
def test_load_flat_yaml_equals_pyyaml_on_maps(d):
    text = dump_flat_yaml(d)  # (an empty map is one newline: PyYAML None)
    assert load_flat_yaml(text) == yaml.safe_load(text) == d


def test_read_yaml_without_pyyaml(tmp_path, monkeypatch):
    p = tmp_path / "data.yaml"
    p.write_text("# data\ntrain: ../x  # rgb\nnc: 2\nnames: ['a', \"b\"]\n"
                 "val:\n  - v1\n  - v2\n")
    want = yaml.safe_load(p.read_text())
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert read_yaml(p) == want
    p.write_text("a:\n  b: 1\n")
    with pytest.raises(ValueError, match="nested"):
        read_yaml(p)


# --------------------------------------------------------- dataset tools
@pytest.fixture()
def tree(tmp_path):
    make_paired_dataset(str(tmp_path / "ds"), n_images=4, img_size=IMG,
                        nc=2, seed=3)
    return tmp_path / "ds"


def _listing(d: Path) -> dict:
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def test_autosplit_and_flatten_equal_the_jax_tool(tree, tmp_path):
    jt = _jax_tool("dataset_tools")
    jt.autosplit(str(tree), (0.5, 0.3, 0.2))
    want = {n: (tmp_path / n).read_text() if (tmp_path / n).exists() else ""
            for n in dataset_tools.SPLITS}
    got = dataset_tools.autosplit(str(tree), (0.5, 0.3, 0.2))
    for n in dataset_tools.SPLITS:
        text = (tmp_path / n).read_text() if (tmp_path / n).exists() else ""
        assert text == want[n] and text.splitlines() == got[n]
    assert sum(map(len, got.values())) == 8  # RGB and IR images
    jt.flatten_recursive(str(tree))
    flat = Path(str(tree) + "_flat")
    want_flat = _listing(flat)
    for p in flat.iterdir():
        p.unlink()
    assert dataset_tools.flatten_recursive(str(tree)) == 12
    assert _listing(flat) == want_flat


def test_extract_boxes_equals_the_jax_tool_and_png_without_cv2(
        tree, tmp_path, monkeypatch):
    out = tmp_path / "classifier"
    _jax_tool("dataset_tools").extract_boxes(str(tree))
    want = _listing(out)
    for p in out.rglob("*.jpg"):
        p.unlink()
    crops = dataset_tools.extract_boxes(str(tree))
    assert _listing(out) == want and len(crops) == len(want) > 0
    for p in out.rglob("*.jpg"):
        p.unlink()
    monkeypatch.setitem(sys.modules, "cv2", None)
    crops = dataset_tools.extract_boxes(str(tree))
    assert sorted(str(p.relative_to(out).with_suffix(".jpg"))
                  for p in crops) == sorted(want)
    rows = 0
    for src in sorted((tree / "rgb" / "images").glob("*.png")):
        im = imread(src)
        h, w = im.shape[:2]
        lab = np.loadtxt(tree / "rgb" / "labels" / f"{src.stem}.txt",
                         ndmin=2, dtype=np.float32)
        for j, (c, x, y, bw, bh) in enumerate(lab):
            b = np.array([x, y, bw, bh], np.float32) * np.array([w, h, w, h])
            x1, y1 = int(max(b[0] - b[2] / 2, 0)), int(max(b[1] - b[3] / 2, 0))
            x2, y2 = int(min(b[0] + b[2] / 2, w)), int(min(b[1] + b[3] / 2, h))
            crop = imread(out / str(int(c)) / f"{src.stem}_{j}.png")
            np.testing.assert_array_equal(crop, im[y1:y2, x1:x2])
            rows += 1
    assert rows == len(crops)


# ------------------------------------------------------ export_torch_ckpt
_FAKE_YOLO = '''
from multispectral_object_detection_tpu_torch.models.model import (
    DetectionModel)
from multispectral_object_detection_tpu_torch.models.parser import (
    parse_model_config)


class Model(DetectionModel):
    """Stands in for the reference's models.yolo.Model."""

    def __init__(self, cfg, nc):
        super().__init__(parse_model_config(cfg, nc=nc))
'''


@pytest.fixture(scope="module")
def reference_pt(tmp_path_factory):
    """A reference-style checkpoint: {'model': half, 'ema': fp32} pickled
    modules whose class lives in ``<tmp>/ref/models/yolo.py``."""
    tmp_path = tmp_path_factory.mktemp("export")
    repo = tmp_path / "ref"
    (repo / "models").mkdir(parents=True)
    (repo / "models" / "__init__.py").write_text("")
    (repo / "models" / "yolo.py").write_text(_FAKE_YOLO)
    cfg = configs.get_config(CFG, nc=2)
    sys.path.insert(0, str(repo))
    try:
        from models.yolo import Model

        nets = []
        for seed in (0, 1):
            m = Model(cfg, nc=2)
            m.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                               random_state_dict(m, seed).items()})
            nets.append(m.eval())
        src = {"model": {k: v.half().float() if v.is_floating_point() else v
                         for k, v in nets[0].state_dict().items()},
               "ema": nets[1].state_dict()}
        torch.save({"epoch": 3, "model": nets[0].half(), "ema": nets[1]},
                   tmp_path / "best.pt")
    finally:
        sys.path.remove(str(repo))
        for k in [k for k in sys.modules if k.split(".")[0] == "models"]:
            del sys.modules[k]
    yield dict(repo=str(repo), pt=str(tmp_path / "best.pt"), cfg=cfg,
               src=src)
    for k in [k for k in sys.modules if k.split(".")[0] == "models"]:
        del sys.modules[k]


@pytest.mark.parametrize("ema", [False, True], ids=["model", "ema"])
def test_export_torch_ckpt(reference_pt, tmp_path, monkeypatch, ema):
    r = reference_pt
    flag = ["--ema"] * ema
    jnpz, pnpz, ppt = (str(tmp_path / n) for n in ("j.npz", "p.npz", "p.pt"))
    monkeypatch.setattr(sys, "argv", ["export_torch_ckpt", "--pt", r["pt"],
                                      "--repo", r["repo"], "--out", jnpz]
                        + flag)
    monkeypatch.setattr(sys, "path", list(sys.path))  # the JAX tool's insert
    _jax_tool("export_torch_ckpt").main()
    base = ["--pt", r["pt"], "--repo", r["repo"]] + flag
    assert export_torch_ckpt.main(base + ["--out", pnpz]) == 0
    assert export_torch_ckpt.main(base + ["--out", ppt]) == 0
    with np.load(jnpz) as a, np.load(pnpz) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    sd = load_inference_params(ppt)
    src = r["src"]["ema" if ema else "model"]
    assert sorted(sd) == sorted(src)
    for k, v in src.items():
        np.testing.assert_array_equal(sd[k], v.numpy())
    got, want = build_model(r["cfg"]), build_model(r["cfg"])
    load_reference_state_dict(got, sd)
    load_reference_state_dict(want, src)
    x = torch.rand((1, 3, IMG, IMG), generator=torch.Generator()
                   .manual_seed(0))
    with torch.no_grad():
        for a, b in zip(got(x, x), want(x, x)):
            assert torch.equal(a, b)


def test_export_torch_ckpt_without_ema(tmp_path):
    m = build_model(configs.get_config(CFG, nc=2))
    torch.save({"model": m, "ema": None}, tmp_path / "s.pt")
    assert export_torch_ckpt.main(["--pt", str(tmp_path / "s.pt"), "--out",
                                   str(tmp_path / "o.pt"), "--ema"]) == 1


# ------------------------------------------------------------ resume_runs
def _fake_run(root: Path, name: str, epoch: int, opt: dict, state: str):
    (root / name / "last").mkdir(parents=True)
    (root / name / "last" / "meta.json").write_text(json.dumps(
        {"epoch": epoch, "best_fitness": 0.0}))
    (root / name / "last" / state).write_bytes(b"")
    if opt is not None:
        (root / name / "opt.yaml").write_text(dump_flat_yaml(opt))


def test_resume_runs(tmp_path, caplog, capsys, monkeypatch):
    caplog.set_level("INFO")
    # no TensorBoard (its import takes seconds) and no plots here
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(plots, "available", lambda: False)
    make_paired_dataset(str(tmp_path / "data"), n_images=4, img_size=IMG,
                        nc=2, seed=5)
    rgb, ir = (str(tmp_path / "data" / s / "images") for s in ("rgb", "ir"))
    data = tmp_path / "data.yaml"
    data.write_text(yaml.safe_dump({"train_rgb": rgb, "train_ir": ir,
                                    "val_rgb": rgb, "val_ir": ir, "nc": 2,
                                    "names": ["red", "blue"]}))
    root = tmp_path / "runs"
    r = train_cli.run(train_cli.parse_args([
        "--data", str(data), "--cfg", CFG, "--epochs", "2", "--batch-size",
        "4", "--img-size", str(IMG), "--fp32", "--noval", "--noautoanchor",
        "--device", "cpu", "--project", str(root), "--name", "exp"]))
    run = Path(r["save_dir"])
    for f in ("opt.yaml", "hyp.yaml"):  # the run's own files
        text = (run / f).read_text()
        assert load_flat_yaml(text) == yaml.safe_load(text)
    opt = load_flat_yaml((run / "opt.yaml").read_text())
    assert resume_runs.find_interrupted(str(root)) == []  # finished
    opt["epochs"] = 3
    (run / "opt.yaml").write_text(dump_flat_yaml(opt))
    _fake_run(root, "jax", 0, dict(opt, epochs=5), "state.msgpack")
    _fake_run(root, "dict_data", 0, dict(opt, data=str({"nc": 2})),
              "state.pt")
    _fake_run(root, "finished", 4, dict(opt, epochs=5), "state.pt")
    _fake_run(root, "no_opt", 0, None, "state.pt")

    def key(t):
        return str(t[0])

    want = sorted(_jax_tool("resume_runs").find_interrupted(str(root)),
                  key=key)
    got = resume_runs.find_interrupted(str(root))
    assert got == want
    assert [p.name for p, _, _ in got] == ["dict_data", "exp", "jax"]
    caplog.clear()
    res = resume_runs.resume_all(str(root))
    out = capsys.readouterr().out
    assert f"resumed from {run / 'last'} at epoch 2" in caplog.text
    assert f"resuming {run} from epoch 2 / 3" in out
    assert f"skipping {root / 'jax'}: a JAX package run" in out
    assert f"skipping {root / 'dict_data'}: its data was passed as a dict" \
        in out
    assert res[str(run)]["save_dir"] == str(run)
    lines = (run / "results.txt").read_text().splitlines()
    assert [ln.split()[1] for ln in lines] == ["0/1", "1/1", "2/2"]
    assert json.loads((run / "last" / "meta.json").read_text())["epoch"] == 2
    assert [p.name for p, _, _ in resume_runs.find_interrupted(
        str(root))] == ["dict_data", "jax"]


# -------------------------------------------------------------------- mfu
def test_mfu_counts():
    def count(*argv):
        return mfu.run(mfu.parse_args(["--cfg", CFG, "--img", str(IMG),
                                       "--device", "cpu", *argv]))

    fwd = count()
    model = build_model(configs.get_config(CFG, nc=3), dtype=torch.bfloat16)
    assert fwd["gflops_per_pair"] == estimate_flops(model, IMG) / 1e9
    assert count("--tta")["gflops_per_pair"] > fwd["gflops_per_pair"]
    none = count("--train", "--batch", "2")
    blocks = count("--train", "--batch", "2", "--remat", "blocks")
    assert 2.5 <= none["gflops_per_pair"] / fwd["gflops_per_pair"] <= 3.5
    assert none["gflops_per_step"] == 2 * none["gflops_per_pair"]
    assert blocks["gflops_per_step"] > none["gflops_per_step"]


def test_mfu_arithmetic():
    def line(flops, peak, *argv):
        return mfu.result(mfu.parse_args(list(argv)), flops, peak, "card")

    assert "mfu_pct" not in line(2e9, 0.0, "--pairs-per-s", "100")  # no peak
    assert "mfu_pct" not in line(2e9, 1e12)  # no rate
    r = line(2e9, 1e12, "--pairs-per-s", "100")
    assert r["gflops_per_pair"] == 2.0 and r["card"] == "card"
    assert r["achieved_tflops"] == pytest.approx(0.2)
    assert r["mfu_pct"] == pytest.approx(20.0)
    r = line(4e9, 1e12, "--train", "--batch", "2", "--ms-per-step", "8")
    assert r["gflops_per_pair"] == 2.0 and r["gflops_per_step"] == 4.0
    assert r["achieved_tflops"] == pytest.approx(0.5)
    assert r["mfu_pct"] == pytest.approx(50.0) and r["peak_tflops"] == 1.0


def test_mfu_peak_lookup():
    assert mfu.card_peak("NVIDIA H100 80GB HBM3") == 989.4e12
    assert mfu.card_peak("NVIDIA H100 PCIe") == 756.5e12
    assert mfu.card_peak("NVIDIA A100-SXM4-80GB", 312e12) == 312e12
    with pytest.raises(SystemExit, match="--peak"):
        mfu.card_peak("NVIDIA A100-SXM4-80GB")


# --------------------------------------------------------------- profile
def test_by_kind_first_match_wins():
    kernels = [("void gemm_wgmma_kernel<128>(...)", 1.0, 96),
               ("conv_wgmma_kernel", 2.0, 84),  # K2's, not "convolution"
               ("sm90_xmma_fprop_implicit_gemm_bf16", 4.0, 10),
               ("vectorized_elementwise_kernel<silu>", 0.5, 20),  # silu first
               ("elementwise_kernel<add>", 0.25, 8),
               ("mystery", 0.125, 2)]
    got = profile_model.by_kind(kernels, profile_model.SERVING_KINDS, runs=2)
    assert got["CFT kernels"] == {"ms": 0.5, "launches": 48}
    assert got["C3 kernel (K2)"] == {"ms": 1.0, "launches": 42}
    assert got["convolution"] == {"ms": 2.0, "launches": 5}
    assert got["silu"] == {"ms": 0.25, "launches": 10}
    assert got["other elementwise (bias add, residual add)"]["launches"] == 4
    assert got["other"] == {"ms": 0.0625, "launches": 1}
    assert sum(v["ms"] for v in got.values()) == sum(k[1] for k in kernels) / 2
    train = profile_model.by_kind([("cudnn_dgrad_kernel", 1.0, 1),
                                   ("multi_tensor_apply_kernel", 1.0, 1)],
                                  profile_model.TRAIN_KINDS)
    assert train["convolution"]["launches"] == 1
    assert train["optimizer and EMA (foreach)"]["launches"] == 1
    with pytest.raises(ValueError, match="no device events"):
        profile_model.by_kind([], profile_model.SERVING_KINDS)


def test_idle_by_span_charges_each_gap_to_the_innermost_span():
    from types import SimpleNamespace as NS

    def ev(name, dev, a, b, note=False):
        return NS(name=name, device_type=NS(name=dev), is_user_annotation=note,
                  time_range=NS(start=a, end=b))

    events = [ev("ProfilerStep#1", "CPU", 0, 100, True),
              ev("call", "CPU", 0, 90, True), ev("nms", "CPU", 40, 80, True),
              ev("nms", "CUDA", 41, 60, True),  # its gpu_user_annotation
              ev("k1", "CUDA", 10, 30), ev("k2", "CUDA", 20, 42),
              ev("k3", "CUDA", 50, 55), ev("k4", "CUDA", 85, 95),
              ev("k5", "CUDA", 96, 99)]
    got = profile_model.idle_by_span(events, runs=2)
    # gaps: 42-50 at 42 (inside nms), 55-85 at 55 (nms), 95-96 (no span)
    assert got == {"call": {"idle_ms": 0.0, "host_ms": 0.045},
                   "nms": {"idle_ms": 0.019, "host_ms": 0.02},
                   "(no span)": {"idle_ms": 0.0005, "host_ms": 0.0}}


def test_kernel_events_leave_out_the_span_annotations():
    from types import SimpleNamespace as NS

    def avg(key, dev, ms, note=False):
        return NS(key=key, device_type=NS(name=dev), is_user_annotation=note,
                  self_device_time_total=ms * 1e3, count=1,
                  self_cpu_time_total=ms * 1e3)

    prof = NS(key_averages=lambda: [
        avg("ProfilerStep#2", "CPU", 9.0, True),
        avg("model.forward", "CUDA", 30.0, True),  # gpu_user_annotation
        avg("model.forward", "CPU", 35.0, True),
        avg("sm90_xmma_fprop", "CUDA", 2.0), avg("aten::add", "CPU", 1.0)])
    assert profile_model.kernel_events(prof) == [("sm90_xmma_fprop", 2.0, 1)]
    assert profile_model.kernel_events(prof, "cpu") == [("aten::add", 1.0, 1)]


def test_profile_model_on_the_cpu(capsys):
    args = profile_model.parse_args(["--cfg-scale", "n", "--img", str(IMG),
                                     "--batch", "1", "--iters", "1", "--top",
                                     "5", "--device", "cpu"])
    res = profile_model.run(args)
    out = capsys.readouterr().out
    assert out.startswith("TOTAL device: ") and "device idle" in out
    assert len(out.split("ms/iter  calls  kernel\n")[1].splitlines()) == 5
    assert res["device_ms"] == pytest.approx(
        sum(v["ms"] for v in res["by_kind"].values()))
    assert {"model.forward", "fusion.cft", "nms"} <= set(res["spans"])
    assert res["spans"]["model.forward"]["host_ms"] > 0
    if not torch.cuda.is_available():  # no fallback to the CPU
        assert profile_model.main([]) == 1 and mfu.main([]) == 1
