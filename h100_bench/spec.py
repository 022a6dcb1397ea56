"""Finds every piece of a cell by the names in ``BENCHMARK.json``.

* a configuration: the ``file`` its entry names (``configs/<name>.json``);
* a traffic mix: ``traffic/<mix>.json``, whose ``kind`` names the module
  ``kinds/<kind>.py`` that drives it;
* a cell's limits of correctness: ``limits/<cell>.json``;
* a per-layer metric ``<family>.<part>``: the reader of its family,
  ``metrics/<family>.py``.
"""

import importlib
import importlib.util
import json
from pathlib import Path

__all__ = ["BENCH_DIR", "REPO_DIR", "load_benchmark", "cell_parts",
           "end_to_end_for", "per_layer_for", "load_reader"]

BENCH_DIR = Path(__file__).resolve().parent
REPO_DIR = BENCH_DIR.parent


def _json(path: Path) -> dict:
    with open(path) as handle:
        return json.load(handle)


def load_benchmark(path: Path = None) -> dict:
    return _json(path or REPO_DIR / "BENCHMARK.json")


def _named(entries, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"BENCHMARK.json names no {what} {name!r}")


def cell_parts(bench: dict, workload: str) -> dict:
    """Every part of a cell: its entry, its configuration, every
    configuration by name, its traffic mix, its limits and its kind's
    module."""
    entry = _named(bench["workloads"], workload, "workload")
    configs = {c["name"]: _json(REPO_DIR / c["file"])
               for c in bench["configs"]}
    mix = _json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    return {"entry": entry, "config": configs[entry["config"]],
            "configs": configs, "mix": mix,
            "limits": _json(BENCH_DIR / "limits" / f"{workload}.json"),
            "kind": importlib.import_module(f"h100_bench.kinds.{mix['kind']}")}


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def end_to_end_for(bench: dict, workload: str) -> list:
    return [m for m in bench["end_to_end"] if _applies(m, workload)]


def per_layer_for(bench: dict, workload: str) -> list:
    """The per-layer metrics of a cell: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end_for(bench, workload)}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in reported)]


def load_reader(metric: str):
    """The reader of ``metric``: ``metrics/<family>.py``, the family being
    the name before its first dot."""
    family = metric.split(".", 1)[0]
    spec = importlib.util.spec_from_file_location(
        "h100_bench.metrics." + family.replace("-", "_"),
        BENCH_DIR / "metrics" / f"{family}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
