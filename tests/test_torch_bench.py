"""PyTorch port, bench entry point (``python -m
multispectral_object_detection_tpu_torch.bench``): every leg on the CPU at
the n scale, the one-JSON-line contract, and the refusal to run without a
GPU unless ``--device cpu`` is given."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from multispectral_object_detection_tpu_torch import bench
from multispectral_object_detection_tpu_torch.ops import c3_bottleneck as k2
from tests._torch_port import share_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
MODULE = "multispectral_object_detection_tpu_torch.bench"
SMALL = ["--device", "cpu", "--scale", "n", "--img", "64", "--batch", "2",
         "--iters", "3", "--warmup", "1"]


@pytest.mark.parametrize("extra,metric", [
    ((), "cft_n_64_dual_stream_inference_pairs_per_sec_per_chip"),
    (("--c3-kernel",), "cft_n_64_dual_stream_inference_pairs_per_sec_per_chip"),
    (("--int8",), "cft_n_64_dual_stream_inference_pairs_per_sec_per_chip"),
    (("--tta",), "cft_n_64_dual_stream_inference_tta_pairs_per_sec_per_chip"),
    (("--no-nms", "--fp32-params"),
     "cft_n_64_dual_stream_inference_pairs_per_sec_per_chip"),
])
def test_bench_cpu_smoke(extra, metric):
    k2.reset_launches()
    line = bench.run(SMALL + list(extra))
    assert line["metric"] == metric
    assert line["unit"] == "image-pairs/s"
    assert line["value"] > 0 and line["card"] == "cpu"
    assert line["forwards"] == (1 + 3) * (3 if "--tta" in extra else 1)
    assert k2.LAUNCHES["c3_bottleneck"] == 0  # the CPU runs plain versions


def test_bench_c3_kernel_leg_routes_the_fitting_blocks():
    """n scale: rows 14 and 16 (c_ = 64, n = 3) take the kernel route."""
    model, infer, rgb, ir = bench.prepare(bench.parse_args(
        SMALL + ["--c3-kernel"]))
    calls = []
    for m in model.modules():
        if getattr(m, "takes_kernel", False):
            m.c3_fn = lambda *a, _f=m.c3_fn: calls.append(1) or _f(*a)
    dets = infer(rgb, ir)
    assert len(calls) == 6
    assert dets.boxes.shape == (2, 300, 4)


def test_bench_module_prints_one_json_line():
    r = subprocess.run([sys.executable, "-m", MODULE, *SMALL], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0])["metric"].startswith("cft_n_64_")


def test_bench_without_gpu_exits_nonzero_and_prints_no_metric():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    r = subprocess.run([sys.executable, "-m", MODULE, "--scale", "n",
                        "--img", "64", "--batch", "2"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "metric" not in r.stdout
    assert "CUDA" in r.stderr
