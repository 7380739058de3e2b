"""BENCHMARK.json against the benchmark's files: every cell, configuration
and per-layer metric is found by its name, and the file keeps the
contract's shape."""
import json
import os
import re

import pytest

from portbench import run

ROOT = run.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files(cell):
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    w = run.load_json(run.HERE, "workloads", f"{cell['name']}.json")
    assert w["config"] == cell["config"]
    assert os.path.exists(os.path.join(run.HERE, "modes", f"{w['mode']}.py"))
    assert cell["chips"] == 1 and 0 < len(cell["why"]) <= 200
    ends = [m["name"] for m in run.cell_metrics(cell["name"], False)]
    assert "setup_s" in ends and len(ends) >= 2
    assert run.cell_metrics(cell["name"], True)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    data = json.load(open(os.path.join(ROOT, config["file"])))
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert config["file"].startswith("portbench/configs/")
    assert any(c["config"] == config["name"] for c in BENCH["workloads"])


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25 and metric["source"] in ("host_clock",
                                                                         "device_trace")
    else:
        path = os.path.join(run.HERE, "metrics", f"{metric['name']}.py")
        assert callable(run.load_file_module(path, "m").read)
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    for cell in metric.get("workloads", []):
        assert cell in {c["name"] for c in BENCH["workloads"]}


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_ranges_are_found(metric):
    reader = run.load_file_module(os.path.join(run.HERE, "metrics", f"{metric['name']}.py"), "m")
    for name in getattr(reader, "RANGES", ()):
        spec = run.load_file_module(os.path.join(run.HERE, "ranges", f"{name}.py"), "r")
        assert callable(spec.modules) and NAME.match(name)
