"""Runs of the harness in processes of their own (the tests' own process
holds JAX, loaded by the repository's conftest): a tiny CPU run of each
driver and its result line, the refusal to measure without a card, the
guard against JAX, and a checkout that holds only the benchmark."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
DRIVERS = sorted({json.loads((harness.HERE / "traffic" / f"{w['traffic']}"
                               ".json").read_text())["driver"]: w["name"]
                  for w in BENCH["workloads"]}.items())
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def env():
    e = dict(os.environ)
    e.pop("JAX_PLATFORMS", None)
    e["PYTHONPATH"] = str(ROOT)
    return e


def py(code, cwd=ROOT, timeout=300):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env(),
                          capture_output=True, text=True, timeout=timeout)


TINY = """
import json, sys
from portbench import harness
from portbench.tests._tiny import run_tiny
out = run_tiny({cell!r}, trace={trace})
print(harness.result_line(out))
print(json.dumps(harness.forbidden_modules()), file=sys.stderr)
"""


@pytest.mark.parametrize("driver,cell", DRIVERS)
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cpu_run_prints_the_result_line(driver, cell, trace):
    r = py(TINY.format(cell=cell, trace=trace))
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert LINE_KEYS <= set(line)
    assert set(line) - LINE_KEYS <= {"breakdown", "counters", "checks"}
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0
    assert line["failed"] == 0
    want = {m["name"] for m in BENCH["end_to_end"]
            if cell in m.get("workloads", [cell])}
    if not trace:  # per-layer readers find no device trace on the CPU
        assert set(line["metrics"]) == want
    for k in ("platform", "kind", "count", "memory_peak_bytes"):
        assert k in line["device"]
    assert json.loads(r.stderr.strip().splitlines()[-1]) == []


def test_no_card_no_result():
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        BENCH["workloads"][0]["name"], "--seed",
                        "4294967311", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env(), capture_output=True, text=True,
                       timeout=300)
    if "CUDA" in r.stderr and r.returncode == 0:
        pytest.skip("a card is present")
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "no fallback to the CPU" in r.stderr


def test_guard_names_loaded_jax_modules():
    r = py("import sys, types\n"
           "sys.modules['jaxlib'] = types.ModuleType('jaxlib')\n"
           "sys.modules['multispectral_object_detection_tpu_torchx'] = 1\n"
           "from portbench import harness\n"
           "print(harness.forbidden_modules())")
    assert r.stdout.strip() == "['jaxlib']"


def test_port_modules_load_no_jax():
    r = py("import multispectral_object_detection_tpu_torch.hub, "
           "multispectral_object_detection_tpu_torch.train.trainer, "
           "multispectral_object_detection_tpu_torch.train.evaluator\n"
           "from portbench import harness\n"
           "print(harness.forbidden_modules())")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    e = env()
    e["PYTHONPATH"] = str(tmp_path)
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        BENCH["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       env=e, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
