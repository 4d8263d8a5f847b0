"""PyTorch port, guards: the package stands alone (no JAX, no flax, no
optax, nothing of the JAX package, no yaml, cv2, PIL or flask at import,
the training modules and the tools included; the tools name no TPU
figure), its entry points (``Detector`` and its
``__call__``, the detect CLI, the REST service)
default to CUDA and refuse to fall back to the CPU, and chip_smoke.py fails
without a GPU."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multispectral_object_detection_tpu_torch import hubconf, kernels
from multispectral_object_detection_tpu_torch.cli import detect_cli
from multispectral_object_detection_tpu_torch.hub import Detector
from multispectral_object_detection_tpu_torch.models.configs import (
    yolov5_two_stream)
from multispectral_object_detection_tpu_torch.serve import rest_api
from multispectral_object_detection_tpu_torch.utils.general import (
    select_device)
from tests._torch_port import share_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
for name in ("jax", "flax", "optax", "yaml", "cv2", "PIL", "flask"):
    sys.modules[name] = None  # any import of these now raises ImportError
import multispectral_object_detection_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
jax_pkg = [n for n in sys.modules if n == "multispectral_object_detection_tpu"
           or n.startswith("multispectral_object_detection_tpu.")]
assert not jax_pkg, jax_pkg
print("imported", len([n for n in sys.modules if n.startswith(pkg.__name__)]))
"""


def test_port_imports_without_jax_or_the_jax_package():
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 66  # every module of the package


def test_tools_hold_no_tpu_figure():
    """The port's tools state the card's numbers only: no TPU peak or other
    TPU figure (the JAX tools' v5e peak) in their sources."""
    tools = ROOT / "multispectral_object_detection_tpu_torch" / "tools"
    found = {p.name: m.group(0) for p in sorted(tools.glob("*.py"))
             for m in [re.search(r"\bTPU\b|v5e|197e12|197 TFLOP",
                                 p.read_text())] if m}
    assert len(list(tools.glob("*.py"))) == 6 and not found, found


def _require_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")


def test_detector_without_device_refuses_the_cpu():
    _require_no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        Detector()
    with pytest.raises(RuntimeError, match="CUDA"):
        hubconf.cft_s(nc=1, img_size=64)
    det = hubconf.cft_s(nc=1, img_size=64, device="cpu", conf=0.9)
    img = np.zeros((48, 64, 3), np.uint8)
    assert len(det([img], [img])) == 1  # __call__ runs where it was asked


def test_detect_cli_and_rest_without_device_refuse_the_cpu(tmp_path, capsys):
    _require_no_cuda()
    rc = detect_cli.main(["--weights", "w.pt", "--source1", str(tmp_path),
                          "--project", str(tmp_path / "runs")])
    assert rc == 1 and "CUDA" in capsys.readouterr().err
    assert not (tmp_path / "runs").exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        rest_api.main(["--model", "yolov5n", "--port", "0"])


@pytest.mark.parametrize("device,want", [(None, None), ("cuda", None),
                                         ("cuda:0", None), ("cpu", "cpu")])
def test_select_device(device, want):
    if want is None:
        _require_no_cuda()
        with pytest.raises(RuntimeError):
            select_device(device)
    else:
        assert select_device(device) == torch.device(want)


def test_detector_rejects_malformed_batches():
    det = Detector(yolov5_two_stream("n", nc=1), nc=1, img_size=64,
                   dtype=torch.float32, device="cpu")
    good = np.zeros((1, 64, 64, 3), np.uint8)
    for bad in (good.astype(np.float32), np.zeros((1, 32, 32, 3), np.uint8),
                np.zeros((64, 64, 3), np.uint8)):
        with pytest.raises(ValueError):
            det.infer(bad, good)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels._nvcc()


def test_chip_smoke_without_gpu_fails_and_prints_no_result():
    _require_no_cuda()
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
