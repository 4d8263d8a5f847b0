"""PyTorch port, plots, loggers and the general helpers on the CPU: every
plot of utils/plots.py writes its file (the JAX package's smoke tests), a
plot without matplotlib raises naming it, the LR plot follows the port's
schedule; ``ExperimentLogger`` with a fake wandb module (every W&B call)
and TensorBoard, and without wandb a warning and no-ops; ``check_file``,
``check_dataset``, ``colorstr``, ``check_requirements`` and
``check_git_status`` as the JAX package's."""

from pathlib import Path

import numpy as np
import pytest

from multispectral_object_detection_tpu_torch.utils import general, plots
from multispectral_object_detection_tpu_torch.utils.loggers import (
    ExperimentLogger)
from tests._torch_port import install_fake_wandb  # noqa: F401
from tests._torch_port import share_torch_threads  # noqa: F401


def _labels(n=4):
    rng = np.random.default_rng(0)
    return [np.concatenate([rng.integers(0, 3, (5, 1)),
                            rng.uniform(0.1, 0.9, (5, 4))], 1).astype(
                                np.float32) for _ in range(n)]


def test_plots_smoke(tmp_path):
    plots.plot_labels(_labels(5), ["a", "b", "c"], str(tmp_path))
    imgs = np.random.default_rng(0).integers(0, 255, (4, 64, 64, 3),
                                             dtype=np.uint8)
    targets = np.array([[0, 0, 0.5, 0.5, 0.3, 0.3],
                        [1, 1, 0.4, 0.6, 0.2, 0.2]], dtype=np.float32)
    plots.plot_batch(imgs, targets, np.ones(2), str(tmp_path / "b.jpg"),
                     ["a", "b"])
    px = np.linspace(0, 1, 50)
    plots.plot_pr_curve(px, [1 - px, 1 - px ** 2], np.array([[0.5], [0.7]]),
                        str(tmp_path / "pr.png"), ["a", "b"])
    plots.plot_confusion_matrix(np.array([[5, 1, 0], [0, 4, 1], [1, 0, 3]]),
                                ["a", "b"], str(tmp_path / "cm.png"))
    plots.plot_mc_curve(px, np.stack([px, px ** 2]), str(tmp_path / "f1.png"),
                        ["a", "b"], ylabel="F1")
    for f in ("labels.png", "b.jpg", "pr.png", "cm.png", "f1.png"):
        assert (tmp_path / f).stat().st_size > 0, f


def test_plots_tail_smoke(tmp_path):
    from multispectral_object_detection_tpu_torch.train.optim import OptHyp

    plots.plot_lr_schedule(OptHyp(), steps_per_epoch=20, epochs=5,
                           total_batch_size=16, save_dir=str(tmp_path))
    keys = ["lr0", "momentum", "box"]
    rows = np.column_stack([np.random.default_rng(0).random((6, 1)),
                            np.random.default_rng(1).random((6, 3))])
    np.savetxt(tmp_path / "evolve.txt", rows)
    plots.plot_evolution(str(tmp_path / "evolve.txt"), keys,
                         str(tmp_path / "evolve.png"))
    np.savetxt(tmp_path / "study_x.txt",
               [[256, .5, .5, .4, .3, 2.0, 1.0], [320, .6, .5, .5, .35, 3, 1]])
    plots.plot_study([str(tmp_path / "study_x.txt")],
                     str(tmp_path / "study.png"))
    plots.plot_label_correlogram(_labels(), str(tmp_path))
    (tmp_path / "results.txt").write_text(
        "epoch 0/1 box 0.1 obj 0.2 cls 0.3 total 0.6 | P 0.1 R 0.2 mAP50 "
        "0.3 mAP75 0.2 mAP 0.1\nepoch 1/1 box 0.09 obj 0.2 cls 0.3 total "
        "0.59 | P 0.2 R 0.3 mAP50 0.4 mAP75 0.3 mAP 0.2\n")
    plots.plot_results(str(tmp_path / "results.txt"),
                       str(tmp_path / "results.png"))
    for f in ("LR.png", "evolve.png", "study.png", "labels_correlogram.jpg",
              "results.png"):
        assert (tmp_path / f).stat().st_size > 0, f


def test_lr_plot_replays_the_port_schedule(tmp_path, monkeypatch):
    from multispectral_object_detection_tpu_torch.train import optim

    calls = []
    real = optim.warmup_schedules

    def spy(*a, **k):
        sched = real(*a, **k)
        return lambda ni: calls.append(ni) or sched(ni)

    monkeypatch.setattr(optim, "warmup_schedules", spy)
    plots.plot_lr_schedule(optim.OptHyp(), 3, 2, 16, str(tmp_path))
    assert calls == list(range(6))


def test_without_matplotlib_a_plot_raises_naming_it(tmp_path, monkeypatch):
    monkeypatch.setattr(plots, "available", lambda: False)
    plots._pyplot.cache_clear()
    try:
        with pytest.raises(ImportError, match="matplotlib is not installed"):
            plots.plot_labels(_labels(), ["a"], str(tmp_path))
    finally:
        plots._pyplot.cache_clear()
    assert not list(tmp_path.iterdir())


def test_logger_with_wandb_and_tensorboard(tmp_path, monkeypatch):
    run = install_fake_wandb(monkeypatch)
    xlog = ExperimentLogger(str(tmp_path), enable_tb=True, enable_wandb=True,
                            config={"a": 1}, run_name="r", entity="me")
    assert run.init_kw == {"dir": str(tmp_path), "name": "r",
                           "config": {"a": 1}, "entity": "me"}
    xlog.log_epoch(0, [0.1, 0.2, 0.3], {"mp": 0.5, "map50": 0.4,
                                        "val_loss": [1, 2, 3]},
                   lrs={"lr0": 0.01})
    payload, step = run.logged[-1]
    assert step == 0 and payload["metrics/mAP_0.5"] == 0.4
    assert payload["val/cls_loss"] == 3 and payload["x/lr0"] == 0.01
    d = tmp_path / "data"
    d.mkdir()
    art = xlog.log_dataset_artifact({"train_rgb": str(d), "nc": 2})
    assert art.refs == [("file://" + str(d.resolve()), "train_rgb")]
    assert xlog.log_model(str(d), 1, 0.5, save_period=2) is None
    model = xlog.log_model(str(d), 2, 0.5, best=True, save_period=2)
    assert model.aliases == ["latest", "epoch2", "best"]
    xlog.log_bbox_debug_images([np.zeros((8, 8, 3), np.uint8)],
                               [(np.array([[1, 1, 4, 4]]), np.array([0.9]),
                                 np.array([1]))], ["a", "b"])
    panel = run.logged[-1][0]["Bounding Box Debugger/Images"][0]
    assert panel[2]["predictions"]["box_data"][0]["box_caption"] == "b 0.900"
    assert xlog.resume_from_artifact("wandb-artifact://e/p/m:v0",
                                     str(tmp_path / "a")) == str(
                                         tmp_path / "a")
    assert run.used == ["e/p/m:v0"]
    assert xlog.resume_from_artifact(str(d), "x") is None
    xlog.close()
    assert run.finished and list((tmp_path / "tb").glob("events.*"))


def test_logger_without_wandb_warns_and_does_nothing(tmp_path, monkeypatch,
                                                    caplog):
    import sys

    monkeypatch.setitem(sys.modules, "wandb", None)
    xlog = ExperimentLogger(str(tmp_path), enable_tb=False,
                            enable_wandb=True)
    assert "wandb unavailable" in caplog.text and xlog.wandb_run is None
    xlog.log_epoch(0, [1, 2, 3], {})
    assert xlog.log_dataset_artifact({}) is None
    assert xlog.log_model(str(tmp_path), 0, 0.0) is None
    xlog.close()


def test_general_helpers_match_jax(tmp_path, monkeypatch):
    from multispectral_object_detection_tpu.utils import general as jg

    assert general.colorstr("red", "x") == jg.colorstr("red", "x")
    assert general.colorstr("y") == jg.colorstr("y")
    (tmp_path / "a" / "b").mkdir(parents=True)
    (tmp_path / "a" / "b" / "d.yaml").write_text("nc: 1\n")
    monkeypatch.chdir(tmp_path)
    assert general.check_file("d.yaml") == "./a/b/d.yaml"
    assert general.check_file("a/b/d.yaml") == "a/b/d.yaml"
    with pytest.raises(AssertionError, match="File Not Found"):
        general.check_file("nothing.yaml")
    general.check_dataset({"val": str(tmp_path / "a")})
    with pytest.raises(FileNotFoundError, match="Dataset not found"):
        general.check_dataset({"val_rgb": str(tmp_path / "x")},
                              autodownload=False)
    with pytest.raises(FileNotFoundError, match="still missing"):
        general.check_dataset({"val_ir": str(tmp_path / "x"),
                               "download": "r = 0"})
    assert general.check_requirements(("numpy", "no_such_module_xyz")) == [
        "no_such_module_xyz"]
    assert isinstance(general.check_git_status(str(Path(__file__).parent)),
                      str)
