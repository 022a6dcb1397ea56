"""The control: the plain reference put in the program's place in the
nearest precision below the configurations' bf16 (fp8 e4m3 products)
has to fail at least one of a cell's numbers, and so has a loss taken
over half the batch. At a tiny size on the CPU; at the cell's own size
on a card (``cuda`` marker), as the limits were set there
(``python3 h100_bench/readings.py --control``)."""

import pytest
import torch

from h100_bench.spec import cell_parts, load_benchmark
from h100_bench.tests.tiny import tiny_parts, with_held_out
from h100_bench.trace import Tracer

BENCH = with_held_out(load_benchmark())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size runs the "
                    "program's kernels, which have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _readings(parts, device, seconds):
    cell = parts["kind"].Cell(parts["config"], parts["mix"], 2 ** 31 + 9,
                              device, parts["configs"])
    cell.setup()
    cell.window(seconds, Tracer(False, device))
    cell.release()
    return cell.control()


def _fails(row, limits) -> bool:
    if not isinstance(row, dict):
        row = {"frame_mean_abs": row}
    return any(row[name] > limit for name, limit in limits.items())


def _assert_controls_fail(rows, limits):
    assert not _fails(rows["program"], limits), rows
    assert _fails(rows["control"], limits), rows
    if "half_batch" in rows:
        assert _fails(rows["half_batch"], limits), rows


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_a_tiny_size(workload):
    parts = tiny_parts(workload, BENCH)
    _assert_controls_fail(_readings(parts, torch.device("cpu"), 0.3),
                          parts["limits"])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_the_cells_size(card, workload):
    parts = cell_parts(BENCH, workload)
    _assert_controls_fail(_readings(parts, card, 2.0), parts["limits"])
