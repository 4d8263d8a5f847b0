"""BENCHMARK.json against the rules its format keeps, and every cell's files
found by name: configuration, traffic mix and its driver, limits, and a
reader for each per-layer metric."""

import json
import re

import pytest

from portbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    job = harness.load_job(cell, 1, 1.0, False)
    w = job.workload
    assert NAME.match(w["name"]) and w["chips"] == 1
    assert len(w["why"]) <= 200 and "\n" not in w["why"]
    assert (harness.HERE / "drivers" / f"{job.traffic['driver']}.py").exists()
    assert set(job.limits) >= {"head_gap"} or job.limits
    for m in job.per_layer:
        assert callable(harness.load_module(
            harness.HERE / "metrics" / f"{m['name']}.py").read)
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    e2e = [m for m in BENCH["end_to_end"]
           if cell in m.get("workloads", [cell])]
    assert len(e2e) >= 2 and job.per_layer


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    cfg = json.loads((harness.ROOT / conf["file"]).read_text())
    assert cfg["name"] == conf["name"] and cfg["reduced"] == conf["reduced"]
    assert conf["file"].startswith("portbench/configs/")
    assert set(harness.MODEL_KEYS) <= set(cfg)
    used = {w["config"] for w in BENCH["workloads"]}
    assert conf["name"] in used
