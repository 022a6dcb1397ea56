"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files it resolves to."""

import json
import re

import pytest

from h100_bench.spec import (BENCH_DIR, REPO_DIR, cell_parts, end_to_end_for,
                             load_benchmark, load_reader, per_layer_for)

BENCH = load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "layer", "moves",
               "workloads"}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert BENCH["paths"] == ["h100_bench"]
    assert BENCH["command"] == ["python3", "h100_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [entry["name"] for entry in BENCH[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_end_to_end_bounds_and_setup():
    names = {m["name"]: m for m in BENCH["end_to_end"]}
    assert names["setup_s"]["bound"] <= 0.25
    for metric in BENCH["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
        assert metric["better"] in ("lower", "higher")
        assert UNIT.match(metric["unit"])


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_metric_has_a_reader_and_moves_a_reported_metric(metric):
    assert set(metric) <= METRIC_KEYS
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    assert UNIT.match(metric["unit"])
    assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200
    for workload in metric["workloads"]:
        reported = {m["name"] for m in end_to_end_for(BENCH, workload)}
        assert metric["moves"] in reported, (metric["name"], workload)
    reader = load_reader(metric["name"])
    assert reader.read({}) is None
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


@pytest.mark.parametrize("entry", BENCH["workloads"],
                         ids=lambda w: w["name"])
def test_cell_resolves_to_its_files(entry):
    parts = cell_parts(BENCH, entry["name"])
    assert entry["chips"] == 1
    assert len(entry["why"]) <= 200
    assert hasattr(parts["kind"], "Cell")
    assert parts["mix"]["kind"] == parts["kind"].__name__.rsplit(".", 1)[1]
    assert (BENCH_DIR / "traffic" / f"{entry['traffic']}.json").exists()
    assert (BENCH_DIR / "limits" / f"{entry['name']}.json").exists()
    reported = [m["name"] for m in end_to_end_for(BENCH, entry["name"])]
    assert "setup_s" in reported and len(reported) >= 2
    assert per_layer_for(BENCH, entry["name"])
    assert all(limit > 0 for limit in parts["limits"].values())


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_lies_under_paths_and_is_whole(config):
    path = REPO_DIR / config["file"]
    assert config["file"].startswith("h100_bench/") and path.exists()
    data = json.loads(path.read_text())
    assert data["name"] == config["name"]
    assert config["reduced"] == data["reduced"] == []
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])
