"""PyTorch port, the train CLI on the CPU (``--device cpu``) on the mini
n-scale two-stream CFT config (nc=2, 64 px, batch 4, 8 synthetic PNG
pairs, fp32): two epochs warm-started from a JAX checkpoint directory
write ``hyp.yaml``, ``opt.yaml``, ``results.txt`` (with the val loss),
``final.json`` and a ``last`` checkpoint stripped to ``model.pt`` that the
test CLI reads; a bare ``--resume`` continues at epoch 2. ``--device-aug``
and ``--quad`` (batch rounded to a multiple of 4) train an epoch each, and
``--evolve`` writes the JAX CLI's ``evolve.txt`` rows with the same stub
in place of a training run (and ``evolve.png``). The W&B flags log to a
fake wandb module (without one the run warns and trains), ``--resume``
takes a ``wandb-artifact://`` path, a run writes its plots (without
matplotlib it says once that they are skipped), ``--data`` and a
``--cfg`` YAML are found by a recursive search and missing val paths
stop the run; without a GPU and without ``--device cpu`` the CLI exits
non-zero naming CUDA. The training bench prints its JSON line on the CPU
and likewise needs a GPU by default."""

import json
from pathlib import Path

import pytest
import torch
import yaml

from multispectral_object_detection_tpu_torch.cli import test_cli, train_cli
from multispectral_object_detection_tpu_torch.data.synthetic import (
    make_paired_dataset)
from multispectral_object_detection_tpu_torch.models.configs import get_config
from multispectral_object_detection_tpu_torch.models.model import (
    build_model, init_weights)
from tests._torch_port import (  # noqa: F401
    mini_weights, share_torch_threads, write_jax_checkpoint)

CFG, IMG = "yolov5n_fusion_transformerx3", 64


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("traincli")
    rgb, ir = make_paired_dataset(str(root / "data"), n_images=8,
                                  img_size=IMG, nc=2, seed=5)
    data = {"train_rgb": rgb, "train_ir": ir, "val_rgb": rgb, "val_ir": ir,
            "nc": 2, "names": ["red", "blue"]}
    w = mini_weights(1)
    jdir = write_jax_checkpoint(root / "jax", w["params"], w["stats"])
    return dict(root=root, data=data, jax=jdir)


def _run(ws, argv):
    args = train_cli.parse_args(["--data", "unused", "--cfg", CFG,
                                 "--batch-size", "4", "--img-size", str(IMG),
                                 "--fp32", "--device", "cpu", "--project",
                                 str(ws["root"] / "runs")] + argv)
    args.data = ws["data"]  # a dict, as chip_smoke.py passes it
    return train_cli.run(args)


def test_two_epochs_warm_start_resume_and_strip(ws, caplog):
    caplog.set_level("INFO")
    r = _run(ws, ["--epochs", "2", "--weights", ws["jax"],
                  "--compute-val-loss"])
    run = Path(r["save_dir"])
    assert "warm start: " in caplog.text and ws["jax"] in caplog.text
    lines = (run / "results.txt").read_text().splitlines()
    assert [ln.split()[1] for ln in lines] == ["0/1", "1/1"]
    assert all("mAP50" in ln and "val box" in ln for ln in lines)
    final = json.loads((run / "final.json").read_text())
    assert final["seen"] == 8 and len(final["val_loss"]) == 3
    assert r["eval_forwards"] == 2 * 2  # 2 evals of 2 val batches
    hyp = yaml.safe_load((run / "hyp.yaml").read_text())
    assert hyp["lr0"] == 0.01 and hyp["label_smoothing"] == 0.0
    assert yaml.safe_load((run / "opt.yaml").read_text())["epochs"] == 2
    meta = json.loads((run / "last" / "meta.json").read_text())
    assert meta["epoch"] == 1 and meta["stripped"] is True
    assert (run / "last" / "model.pt").is_file()
    # the test CLI reads the stripped checkpoint
    assert _eval(ws, run / "last")["seen"] == 8
    # bare --resume: the newest last/ under --project, at epoch 2
    caplog.clear()
    r2 = _run(ws, ["--epochs", "3", "--resume", "--noval"])
    assert f"resumed from {run / 'last'} at epoch 2" in caplog.text
    lines = (Path(r2["save_dir"]) / "results.txt").read_text().splitlines()
    assert [ln.split()[1] for ln in lines] == ["2/2"]


def _eval(ws, weights):
    args = test_cli.parse_args(["--data", "unused", "--cfg", CFG,
                                "--weights", str(weights), "--img-size",
                                str(IMG), "--batch-size", "4", "--fp32",
                                "--device", "cpu"])
    args.data = ws["data"]
    return test_cli.run(args)


def test_one_epoch_with_the_other_flags(ws):
    flags = ["--rect", "--remat", "dots", "--save-period", "1",
             "--ckpt-every", "2", "--eval-every", "2", "--multi-scale",
             "--freeze", "model.0.", "--cache-images", "--adam",
             "--single-cls", "--label-smoothing", "0.1", "--noautoanchor"]
    r = _run(ws, ["--epochs", "1", "--name", "flags"] + flags)
    run = Path(r["save_dir"])
    line = (run / "results.txt").read_text().splitlines()
    assert len(line) == 1 and "total" in line[0] and "mAP50" in line[0]
    # epoch0/ beside last/ (the final epoch)
    assert (run / "epoch0" / "state.pt").is_file()
    assert (run / "last" / "model.pt").is_file()
    state = torch.load(run / "epoch0" / "state.pt", weights_only=True)
    assert "v" in state["opt"]  # Adam's second moments
    # --freeze model.0.: those parameters keep their initial values
    init = init_weights(build_model(get_config(CFG, nc=1)),
                        torch.Generator().manual_seed(0)).state_dict()
    moved = {k for k in init if k.startswith("model.") and
             init[k].is_floating_point() and
             not torch.equal(state["model"][k], init[k])}
    assert moved and not any(k.startswith("model.0.") and "running" not in k
                             for k in moved)


def test_device_aug_epoch(ws, caplog):
    caplog.set_level("INFO")
    r = _run(ws, ["--epochs", "1", "--name", "devaug", "--device-aug",
                  "--sync-bn", "--local_rank", "0"])
    line = (Path(r["save_dir"]) / "results.txt").read_text().splitlines()
    assert len(line) == 1 and "mAP50" in line[0]
    assert "--sync-bn: always on" in caplog.text
    assert r["eval_forwards"] == 2
    args = train_cli.parse_args(["--data", "unused", "--device-aug",
                                 "--device", "cpu", "--project",
                                 str(ws["root"] / "bad")])
    args.data, args.hyp = ws["data"], {"degrees": 5.0}
    with pytest.raises(SystemExit, match="separable"):
        train_cli.run(args)


def test_quad_epoch_rounds_the_batch(ws, caplog):
    caplog.set_level("WARNING")
    r = _run(ws, ["--epochs", "1", "--name", "quad", "--quad",
                  "--batch-size", "6", "--noval"])
    assert "--quad: batch rounded up to 8" in caplog.text
    line = (Path(r["save_dir"]) / "results.txt").read_text().splitlines()
    assert len(line) == 1 and "total" in line[0]
    with pytest.raises(SystemExit, match="exclusive"):
        _run(ws, ["--quad", "--rect"])


def test_evolve_writes_the_rows_of_jax(ws, tmp_path, monkeypatch):
    """Two generations with the same stub for a training run on both
    sides (its metrics a function of the hyperparameters): the same
    ``evolve.txt`` rows and ``hyp_evolved.yaml``."""
    from multispectral_object_detection_tpu.cli import train_cli as jcli

    def stub(sub):
        h = sub.hyp
        return {"mp": 0.5, "mr": 0.5, "map50": h["lr0"] * 20,
                "map": h["momentum"] - 10 * h["weight_decay"]
                + h["hsv_s"] / 7}

    rows = {}
    for name, cli in (("port", train_cli), ("jax", jcli)):
        monkeypatch.setattr(cli, "run", stub)
        args = cli.parse_args(["--data", "unused", "--evolve", "3",
                               "--project", str(tmp_path), "--name", name,
                               "--seed", "4", "--device", "cpu"])
        cli.evolve(args)
        d = tmp_path / f"{name}_evolve"
        rows[name] = ((d / "evolve.txt").read_text().splitlines(),
                      yaml.safe_load((d / "hyp_evolved.yaml").read_text()))
    assert len(rows["port"][0]) == 3
    assert rows["port"][0] == rows["jax"][0]
    assert rows["port"][1] == pytest.approx(rows["jax"][1])


def test_wandb_flags_log_dataset_epochs_panels_and_models(ws, monkeypatch):
    from tests._torch_port import install_fake_wandb

    run = install_fake_wandb(monkeypatch)
    r = _run(ws, ["--epochs", "2", "--name", "wandb", "--wandb",
                  "--upload-dataset", "--entity", "me", "--bbox-interval",
                  "2", "--save-period", "1", "--artifact-alias", "v1"])
    assert run.init_kw["entity"] == "me" and run.finished
    assert run.init_kw["config"]["artifact_alias"] == "v1"
    data_art, *model_arts = run.artifacts
    assert data_art.type == "dataset" and {n for _, n in data_art.refs} == {
        "train_rgb", "train_ir", "val_rgb", "val_ir"}
    assert [a.metadata["epoch"] for a in model_arts] == [0, 1]
    assert "latest" in model_arts[-1].aliases
    steps = [st for p, st in run.logged if "train/box_loss" in p]
    assert steps == [0, 1]
    panels = [p for p, _ in run.logged if "Bounding Box Debugger/Images" in p]
    assert len(panels) == 1  # epoch 0 only, every 2 epochs
    assert Path(r["save_dir"], "tb").is_dir()


def test_wandb_without_the_package_warns_and_trains(ws, monkeypatch, caplog):
    import sys

    monkeypatch.setitem(sys.modules, "wandb", None)  # import fails
    r = _run(ws, ["--epochs", "1", "--name", "nowandb", "--wandb",
                  "--noval", "--nosave"])
    assert "wandb unavailable" in caplog.text
    assert (Path(r["save_dir"]) / "results.txt").read_text().startswith(
        "epoch 0/0")


def test_resume_from_a_wandb_artifact(ws, monkeypatch, caplog):
    from multispectral_object_detection_tpu_torch.utils import loggers
    from tests._torch_port import install_fake_wandb

    caplog.set_level("INFO")
    run = install_fake_wandb(monkeypatch)
    first = _run(ws, ["--epochs", "1", "--name", "art", "--noval"])
    last = str(Path(first["save_dir"]) / "last")
    monkeypatch.setattr(loggers.ExperimentLogger, "resume_from_artifact",
                        lambda self, path, out: last if path.startswith(
                            "wandb-artifact://") else None)
    _run(ws, ["--epochs", "2", "--name", "art2", "--noval", "--nosave",
              "--resume", "wandb-artifact://me/proj/run_x_model:latest"])
    assert f"resumed from {last} at epoch 1" in caplog.text
    assert run.init_kw["name"] == "art2"


def test_plots_of_a_run(ws):
    r = _run(ws, ["--epochs", "1", "--name", "plots"])
    run = Path(r["save_dir"])
    for f in ("labels.png", "labels_correlogram.jpg", "LR.png",
              "train_batch0.jpg", "train_batch1.jpg", "results.png"):
        assert (run / f).stat().st_size > 0, f


def test_without_matplotlib_plots_are_skipped_once(ws, monkeypatch, caplog):
    from multispectral_object_detection_tpu_torch.utils import plots

    caplog.set_level("INFO")
    monkeypatch.setattr(plots, "available", lambda: False)
    r = _run(ws, ["--epochs", "1", "--name", "noplots"])
    assert caplog.text.count("plots skipped: matplotlib is not "
                             "installed") == 1
    assert not list(Path(r["save_dir"]).glob("*.png"))
    assert (Path(r["save_dir"]) / "results.txt").is_file()


def test_data_and_cfg_paths_are_found_and_val_paths_checked(
        ws, tmp_path, monkeypatch):
    (tmp_path / "cfgs").mkdir()
    (tmp_path / "cfgs" / "mini.yaml").write_text(yaml.safe_dump(
        get_config(CFG, nc=2)))
    (tmp_path / "sets").mkdir()
    (tmp_path / "sets" / "synth.yaml").write_text(yaml.safe_dump(ws["data"]))
    monkeypatch.chdir(tmp_path)
    args = train_cli.parse_args([
        "--data", "synth.yaml", "--cfg", "mini.yaml", "--batch-size", "4",
        "--img-size", str(IMG), "--fp32", "--device", "cpu", "--epochs", "1",
        "--noval", "--nosave", "--project", str(tmp_path / "runs")])
    train_cli.run(args)
    assert args.data == "./sets/synth.yaml"
    assert args.cfg == "./cfgs/mini.yaml"
    missing = dict(ws["data"], val_rgb=str(tmp_path / "nowhere"))
    args = train_cli.parse_args(["--data", "unused", "--cfg", CFG,
                                 "--device", "cpu", "--project",
                                 str(tmp_path / "runs")])
    args.data = missing
    with pytest.raises(FileNotFoundError, match="nowhere"):
        train_cli.run(args)


def test_evolve_plots_fitness_against_each_hyperparameter(ws, tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(train_cli, "run", lambda a: {
        "mp": 0.5, "mr": 0.5, "map50": a.hyp["lr0"], "map": 0.1})
    args = train_cli.parse_args(["--data", "unused", "--evolve", "2",
                                 "--project", str(tmp_path), "--device",
                                 "cpu"])
    train_cli.evolve(args)
    assert (tmp_path / "exp_evolve" / "evolve.png").stat().st_size > 0


def test_cli_without_gpu_and_without_device_cpu_exits(ws, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    rc = train_cli.main(["--data", "unused.yaml", "--cfg", CFG, "--project",
                         str(ws["root"] / "gpu")])
    assert rc != 0 and "CUDA" in capsys.readouterr().err
    assert not (ws["root"] / "gpu").exists()


def test_bench_train_prints_one_json_line_and_needs_a_gpu(capsys):
    from multispectral_object_detection_tpu_torch import bench_train

    argv = ["--cfg", CFG, "--img", "64", "--batch", "2", "--steps", "2",
            "--warmup", "1", "--remat", "blocks"]
    assert bench_train.main(argv + ["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"].endswith("_remat_blocks")
    assert out["peak_gb"] is None and out["state_gb"] is None
    assert len(out["losses"]) == 3 and out["ms_per_step"] > 0
    if not torch.cuda.is_available():
        assert bench_train.main(argv) == 1
        assert "CUDA" in capsys.readouterr().err
