"""Restart every interrupted training run under a root (reference
utils/aws/resume.py): the port's counterpart of ``tools/resume_runs.py``,
with its flags and output lines.

    python -m multispectral_object_detection_tpu_torch.tools.resume_runs \\
        [--root runs/train] [--dry-run]

A run is interrupted when its ``last/meta.json``'s ``epoch + 1`` is below
its ``opt.yaml``'s ``epochs``. Each such run restarts in this process,
one after the other, through the port's train CLI (``cli/train_cli.run``)
with the arguments it was started with: the CLI's defaults with
``opt.yaml`` laid over them (read without PyYAML, ``data/hyps.py``), then
``resume = <run>/last`` and ``exist_ok``, in its own directory. The
device is the one ``opt.yaml`` names (by default CUDA, which fails
without a GPU).

Runs that cannot continue are named and skipped, and the sweep goes on:
a run of the JAX package (``last/state.msgpack``), a ``last/`` without
the port's training state (``state.pt``), and a run whose ``data`` was
passed as a dict rather than a path. A run that fails is reported and
the sweep goes on; the exit code is 1 if any run failed.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path

from ..data.hyps import load_flat_yaml

logger = logging.getLogger(__name__)


def find_interrupted(root: str = "runs/train") -> list:
    """[(run dir, meta, opt)] of the runs under ``root`` whose last epoch
    is below their ``epochs``, in name order."""
    out = []
    for meta_path in sorted(Path(root).glob("*/last/meta.json")):
        run_dir = meta_path.parent.parent
        opt_path = run_dir / "opt.yaml"
        if not opt_path.exists():
            continue
        meta = json.loads(meta_path.read_text())
        opt = load_flat_yaml(opt_path.read_text())
        if meta.get("epoch", 0) + 1 < opt.get("epochs", 0):
            out.append((run_dir, meta, opt))
    return out


def why_not_resumable(run_dir: Path, opt: dict):
    """None if the port can continue ``run_dir``, else the reason."""
    last = run_dir / "last"
    if not (last / "state.pt").is_file():
        if (last / "state.msgpack").is_file():
            return ("a JAX package run (last/state.msgpack): resume it with "
                    "the JAX train CLI")
        return "last/ holds no training state (state.pt)"
    data = opt.get("data")
    if not isinstance(data, str) or data.lstrip().startswith("{"):
        return "its data was passed as a dict, not a path"
    return None


def train_args(run_dir: Path, opt: dict) -> argparse.Namespace:
    """The train CLI's arguments that continue ``run_dir``."""
    from ..cli.train_cli import parse_args

    ns = parse_args(["--data", str(opt["data"])])
    for k, v in opt.items():
        setattr(ns, k, v)
    ns.resume = str(run_dir / "last")
    ns.exist_ok = True
    ns.project, ns.name = str(run_dir.parent), run_dir.name
    return ns


def resume_all(root: str = "runs/train", dry_run: bool = False) -> dict:
    """Resume every interrupted run under ``root``; {run dir: the train
    CLI's result, or the reason it was skipped or failed (a str)}."""
    from ..cli.train_cli import run as train_run

    out = {}
    for run_dir, meta, opt in find_interrupted(root):
        why = why_not_resumable(run_dir, opt)
        if why:
            print(f"skipping {run_dir}: {why}")
            out[str(run_dir)] = f"skipped: {why}"
            continue
        print(f"resuming {run_dir} from epoch {meta.get('epoch', 0) + 1}"
              f" / {opt['epochs']}")
        if dry_run:
            continue
        try:
            out[str(run_dir)] = train_run(train_args(run_dir, opt))
        except (Exception, SystemExit) as e:  # the sweep goes on
            logger.exception(f"{run_dir}: resume failed")
            out[str(run_dir)] = f"failed: {type(e).__name__}: {e}"
    return out


def main(argv=None) -> int:
    logging.basicConfig(format="%(message)s", level=logging.INFO)
    ap = argparse.ArgumentParser(
        "python -m multispectral_object_detection_tpu_torch.tools."
        "resume_runs")
    ap.add_argument("--root", default="runs/train")
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)
    res = resume_all(args.root, args.dry_run)
    return int(any(isinstance(v, str) and v.startswith("failed")
                   for v in res.values()))


if __name__ == "__main__":
    sys.exit(main())
