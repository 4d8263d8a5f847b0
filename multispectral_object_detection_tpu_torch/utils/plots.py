"""Plotting suite, the counterpart of multispectral_object_detection_tpu/
utils/plots.py: label statistics, annotated batch mosaics, PR and
metric-confidence curves, the confusion matrix, the LR schedule, the
image-size study, the evolution scatter, the label correlogram and the
results curves.

matplotlib is imported at first use (Agg backend), never at import, so the
port imports where it is absent (the card): ``available()`` says whether
plots can be drawn, and a plotting function raises ImportError there.
pandas and seaborn stay optional, as in the JAX package.
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

MISSING = "matplotlib is not installed"


def available() -> bool:
    """True where matplotlib can be imported."""
    return importlib.util.find_spec("matplotlib") is not None


@functools.lru_cache(maxsize=None)
def _pyplot():
    if not available():
        raise ImportError(f"plots need matplotlib: {MISSING}")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _colors():
    return _pyplot().rcParams["axes.prop_cycle"].by_key()["color"]


def plot_labels(labels: Sequence[np.ndarray], names: Sequence[str],
                save_dir: str):
    """Class histogram + box-geometry scatter (plots.py:285-331)."""
    plt = _pyplot()
    all_l = np.concatenate([l for l in labels if len(l)], 0) if any(
        len(l) for l in labels) else np.zeros((0, 5))
    fig, axs = plt.subplots(1, 3, figsize=(15, 4))
    nc = max(int(all_l[:, 0].max()) + 1, 1) if len(all_l) else 1
    axs[0].hist(all_l[:, 0], bins=np.arange(nc + 1) - 0.5, rwidth=0.8)
    axs[0].set_xlabel("class")
    axs[1].scatter(all_l[:, 1], all_l[:, 2], s=3, alpha=0.4)
    axs[1].set_xlabel("cx")
    axs[1].set_ylabel("cy")
    axs[2].scatter(all_l[:, 3], all_l[:, 4], s=3, alpha=0.4)
    axs[2].set_xlabel("w")
    axs[2].set_ylabel("h")
    fig.tight_layout()
    fig.savefig(Path(save_dir) / "labels.png", dpi=120)
    plt.close(fig)


def plot_batch(images: np.ndarray, targets: np.ndarray, tmask: np.ndarray,
               path: str, names: Optional[Sequence[str]] = None,
               max_images: int = 8):
    """Annotated batch mosaic (plots.py:128-204). images (B,S,S,3) uint8;
    targets flat (T, 6) normalized."""
    plt = _pyplot()
    colors = _colors()
    b = min(images.shape[0], max_images)
    cols = int(np.ceil(np.sqrt(b)))
    rows = int(np.ceil(b / cols))
    fig, axs = plt.subplots(rows, cols, figsize=(4 * cols, 4 * rows),
                            squeeze=False)
    s = images.shape[1]
    for i in range(rows * cols):
        ax = axs[i // cols][i % cols]
        ax.axis("off")
        if i >= b:
            continue
        ax.imshow(images[i])
        sel = (targets[:, 0] == i) & (tmask > 0)
        for t in targets[sel]:
            c = int(t[1])
            x, y, w, h = t[2] * s, t[3] * s, t[4] * s, t[5] * s
            rect = plt.Rectangle((x - w / 2, y - h / 2), w, h, fill=False,
                                 color=colors[c % len(colors)], lw=1.5)
            ax.add_patch(rect)
            if names:
                ax.text(x - w / 2, y - h / 2 - 2, names[c], fontsize=7,
                        color=colors[c % len(colors)])
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def plot_pr_curve(px: np.ndarray, py: Sequence[np.ndarray], ap: np.ndarray,
                  save_path: str, names: Sequence[str] = ()):
    """PR curves at IoU 0.5 (metrics.py plot_pr_curve equivalent)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 6))
    for i, y in enumerate(py):
        label = (f"{names[i]} {ap[i, 0]:.3f}" if i < len(names)
                 else f"{i} {ap[i, 0]:.3f}")
        ax.plot(px, y, lw=1.5, label=label)
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(fontsize=8)
    fig.savefig(save_path, dpi=150)
    plt.close(fig)


def plot_mc_curve(px: np.ndarray, py: np.ndarray, save_path: str,
                  names: Sequence[str] = (), xlabel: str = "Confidence",
                  ylabel: str = "Metric"):
    """Metric-vs-confidence curves, one line per class plus the mean
    (reference metrics.py plot_mc_curve — the F1/P/R_curve.png emitters of
    test.py:253-257 via ap_per_class(plot=True))."""
    plt = _pyplot()
    py = np.atleast_2d(py)
    fig, ax = plt.subplots(figsize=(7, 6))
    for i, y in enumerate(py):
        label = names[i] if i < len(names) else str(i)
        ax.plot(px, y, lw=1, label=label)
    mean = py.mean(0)
    ax.plot(px, mean, lw=2.5, color="blue",
            label=f"all classes {mean.max():.2f} at "
                  f"{px[mean.argmax()]:.3f}")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(fontsize=8)
    fig.savefig(save_path, dpi=150)
    plt.close(fig)


def plot_confusion_matrix(matrix: np.ndarray, names: Sequence[str],
                          save_path: str):
    plt = _pyplot()
    n = matrix.shape[0]
    norm = matrix / (matrix.sum(0, keepdims=True) + 1e-6)
    fig, ax = plt.subplots(figsize=(8, 7))
    im = ax.imshow(norm, cmap="Blues", vmin=0, vmax=1)
    labels = list(names) + ["background"]
    ax.set_xticks(range(n))
    ax.set_yticks(range(n))
    ax.set_xticklabels(labels[:n], rotation=90, fontsize=7)
    ax.set_yticklabels(labels[:n], fontsize=7)
    ax.set_xlabel("True")
    ax.set_ylabel("Predicted")
    for i in range(n):
        for j in range(n):
            if norm[i, j] > 0.005:
                ax.text(j, i, f"{norm[i, j]:.2f}", ha="center", va="center",
                        fontsize=6,
                        color="white" if norm[i, j] > 0.5 else "black")
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(save_path, dpi=150)
    plt.close(fig)


def plot_lr_schedule(hyp, steps_per_epoch: int, epochs: int,
                     total_batch_size: int, save_dir: str,
                     linear_lr: bool = False):
    """Simulated LR trajectory -> LR.png (plots.py:206-220). The reference
    replays its LambdaLR per epoch; here the port's schedule
    (train/optim.py) is replayed per micro-batch, showing the warmup ramp
    and the per-epoch staircase. ``hyp``: a train/optim.OptHyp."""
    from ..train.optim import warmup_schedules

    plt = _pyplot()

    sched = warmup_schedules(hyp, steps_per_epoch, epochs, total_batch_size,
                             linear_lr)
    ni = np.arange(steps_per_epoch * epochs)
    lr_main, lr_bias = np.array([sched(int(i))[:2] for i in ni],
                                np.float64).reshape(-1, 2).T
    x = ni / steps_per_epoch
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(x, lr_main, label="lr (pg0/pg1)")
    ax.plot(x, lr_bias, label="lr (bias pg2)", alpha=0.7)
    ax.set_xlabel("epoch")
    ax.set_ylabel("LR")
    ax.grid(alpha=0.3)
    ax.set_xlim(0, epochs)
    ax.set_ylim(0)
    ax.legend()
    fig.tight_layout()
    fig.savefig(Path(save_dir) / "LR.png", dpi=150)
    plt.close(fig)


def plot_study(study_files, save_path: str):
    """mAP-vs-latency trade-off curves from study_*.txt rows written by the
    test CLI's --task study (plots.py:253-283 plot_study_txt). Each row:
    img_size P R mAP50 mAP t_infer_ms t_nms_ms."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 5))
    for f in study_files:
        y = np.loadtxt(f, ndmin=2)
        if not y.size:
            continue
        t_total = y[:, 5] + y[:, 6]
        ax.plot(t_total, y[:, 4] * 100, ".-", lw=2, markersize=8,
                label=Path(f).stem.replace("study_", ""))
        for xi, yi, s in zip(t_total, y[:, 4] * 100, y[:, 0]):
            ax.annotate(f"{int(s)}", (xi, yi), fontsize=7,
                        xytext=(2, 2), textcoords="offset points")
    ax.grid(alpha=0.2)
    ax.set_xlabel("total latency (ms/img, infer+NMS)")
    ax.set_ylabel("mAP 0.5:0.95")
    ax.legend(loc="lower right")
    fig.tight_layout()
    fig.savefig(save_path, dpi=150)
    plt.close(fig)


def plot_evolution(evolve_file: str, keys, save_path: str):
    """Hyperparameter-evolution scatter grid (plots.py:333-358): fitness vs
    each evolved hyp, best marked. evolve.txt rows: fitness then one value
    per key (the train CLI's evolve() format)."""
    plt = _pyplot()
    x = np.loadtxt(evolve_file, ndmin=2)
    if not x.size:
        return
    f = x[:, 0]
    n = len(keys)
    cols = 5
    rows = int(np.ceil(n / cols))
    fig = plt.figure(figsize=(2.2 * cols, 2.2 * rows))
    for i, k in enumerate(keys):
        y = x[:, i + 1]
        mu = y[f.argmax()]
        ax = fig.add_subplot(rows, cols, i + 1)
        ax.scatter(y, f, c=f, cmap="viridis", alpha=0.8, edgecolors="none",
                   s=12)
        ax.plot(mu, f.max(), "k+", markersize=12)
        ax.set_title(f"{k} = {mu:.3g}", fontsize=8)
        ax.tick_params(labelsize=6)
        if i % cols:
            ax.set_yticks([])
    fig.tight_layout()
    fig.savefig(save_path, dpi=150)
    plt.close(fig)


def plot_label_correlogram(labels, save_dir: str):
    """xywh pair-scatter correlogram (plots.py:290-296 uses seaborn
    pairplot; plain-matplotlib equivalent so the dependency stays
    optional — seaborn is used when importable)."""
    plt = _pyplot()
    all_l = np.concatenate([l for l in labels if len(l)], 0) if any(
        len(l) for l in labels) else np.zeros((0, 5))
    if not len(all_l):
        return
    cols = ["x", "y", "width", "height"]
    data = all_l[:, 1:5]
    try:
        import pandas as pd
        import seaborn as sn

        sn.pairplot(pd.DataFrame(data, columns=cols), corner=True,
                    diag_kind="auto", kind="hist",
                    diag_kws=dict(bins=50),
                    plot_kws=dict(pmax=0.9)).savefig(
                        Path(save_dir) / "labels_correlogram.jpg", dpi=120)
        plt.close("all")
        return
    except ImportError:
        pass
    fig, axs = plt.subplots(4, 4, figsize=(10, 10))
    for i in range(4):
        for j in range(4):
            ax = axs[i][j]
            if j > i:
                ax.axis("off")
                continue
            if i == j:
                ax.hist(data[:, i], bins=50)
            else:
                ax.hist2d(data[:, j], data[:, i], bins=50, cmin=1)
            if i == 3:
                ax.set_xlabel(cols[j], fontsize=8)
            if j == 0:
                ax.set_ylabel(cols[i], fontsize=8)
            ax.tick_params(labelsize=6)
    fig.tight_layout()
    fig.savefig(Path(save_dir) / "labels_correlogram.jpg", dpi=120)
    plt.close(fig)


def plot_results(results_file: str, save_path: str):
    """Loss/metric curves from results.txt lines (plots.py:412-445)."""
    plt = _pyplot()
    import re

    rows = []
    for line in Path(results_file).read_text().splitlines():
        nums = re.findall(r"(box|obj|cls|total|P|R|mAP50|mAP75|mAP)\s+"
                          r"([0-9.]+)", line)
        if nums:
            rows.append(dict(nums))
    if not rows:
        return
    keys = ["box", "obj", "cls", "total", "P", "R", "mAP50", "mAP"]
    fig, axs = plt.subplots(2, 4, figsize=(16, 7))
    for ax, k in zip(axs.flat, keys):
        ys = [float(r[k]) for r in rows if k in r]
        ax.plot(ys)
        ax.set_title(k)
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
