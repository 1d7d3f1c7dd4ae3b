"""BENCHMARK.json against the files the harness finds by name."""

import json
import re
from pathlib import Path

import pytest

import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_each_configuration_is_its_file(config):
    data = json.loads((ROOT / config["file"]).read_text())
    assert config["file"] == f"portbench/configs/{config['name']}.json"
    assert data["name"] == config["name"]
    assert data["source"] == config["source"] and len(config["source"]) <= 200
    assert data["reduced"] == config["reduced"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_is_its_file(cell):
    loaded = harness.load_cell(cell["name"])
    assert loaded["workload"]["config"] == cell["config"]
    assert loaded["workload"]["traffic"] == cell["traffic"]
    assert loaded["workload"]["chips"] == cell["chips"] == 1
    assert loaded["config"]["name"] == cell["config"]
    assert len(cell["why"]) <= 200
    metrics = harness.benchmark_metrics(cell["name"])
    assert {m["name"] for m in metrics["end_to_end"]} == {"pods_per_s", "setup_s"}
    assert metrics["per_layer"]


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_has_its_reader(metric):
    reader = harness.load_reader(metric["name"])
    assert callable(reader.read)
    assert metric["moves"] == "pods_per_s"
    assert set(metric["workloads"]) <= {w["name"] for w in BENCH["workloads"]}


def test_names_units_and_bounds():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
