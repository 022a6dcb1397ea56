"""The result line's shape, the refusal without a card, and the check
that nothing the benchmark runs loads JAX or the JAX package."""

import ast
import json
import subprocess
import sys

import pytest

from h100_bench.run import FORBIDDEN, run_cell
from h100_bench.spec import BENCH_DIR, REPO_DIR, load_benchmark
from h100_bench.tests.tiny import tiny_parts

BENCH = load_benchmark()
REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(trace):
    result = run_cell(BENCH, "train-8x256", 5, 0.2, trace, "cpu", 0.0,
                      tiny_parts("train-8x256", BENCH))
    extra = ["breakdown"] if trace else []
    assert list(result) == REQUIRED + extra + ["checks"]  # checks last
    assert isinstance(result["correct"], bool)
    for metric in result["metrics"].values():
        assert set(metric) == {"value", "unit"}
    if trace:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(result["device"])
    else:
        assert set(result["metrics"]) == {"step_ms", "setup_s"}
    for check in result["checks"].values():
        assert set(check) == {"value", "limit"}
    json.dumps(result)


def test_refuses_without_a_card():
    done = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", "orbit-8x256",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO_DIR, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert done.returncode != 0
    assert done.stdout == ""


_IMPORTS = """
import sys
sys.path.insert(0, {repo!r})
from h100_bench.run import run_cell
from h100_bench.spec import load_benchmark, load_reader
from h100_bench.tests.tiny import tiny_parts
bench = load_benchmark()
for cell in bench["workloads"]:
    run_cell(bench, cell["name"], 3, 0.2, True, "cpu", 0.0,
             tiny_parts(cell["name"], bench))
for metric in bench["per_layer"]:
    load_reader(metric["name"])
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_a_run_loads_no_jax():
    done = subprocess.run([sys.executable, "-c",
                           _IMPORTS.format(repo=str(REPO_DIR))],
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]
    loaded = set(json.loads(done.stdout.strip().splitlines()[-1]
                            .replace("'", '"')))
    assert not loaded & set(FORBIDDEN)
    assert "fourier_feature_nets_torch" in loaded


def test_the_reference_imports_nothing_of_the_program():
    banned = set(FORBIDDEN) | {"fourier_feature_nets_torch"}
    for path in sorted((BENCH_DIR / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            assert not {n.split(".")[0] for n in names} & banned, path
    done = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {str(REPO_DIR)!r}); "
         "import h100_bench.reference.frame, h100_bench.reference.steps; "
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    assert "fourier_feature_nets_torch" not in done.stdout
