"""The per-layer metrics read from the program's spans
(``fourier_feature_nets_torch.utils.tracing``): each reader on an empty
recorder and on a synthetic session, and the cells with tracing on
printing them: the tiny cells on the CPU, where no CUDA graph is
captured, and the cells' own sizes on a card (``cuda`` marker)."""

from types import SimpleNamespace

import pytest
import torch

from fourier_feature_nets_torch.utils import tracing
from h100_bench.run import run_cell
from h100_bench.spec import cell_parts, load_benchmark, load_reader
from h100_bench.tests.tiny import tiny_parts, with_held_out
from h100_bench.trace import Tracer

BENCH = load_benchmark()
HELD = with_held_out(BENCH)
ORBIT_CELLS = [w["name"] for w in HELD["workloads"]
               if cell_parts(HELD, w["name"])["mix"]["kind"] == "orbit"]
SPAN_SOURCES = ("program_span", "program_counter")
NEW = {m["name"]: m for m in BENCH["per_layer"]
       if m["source"] in SPAN_SOURCES}
# a traced slice's readings, as run.py hands them to a reader
SLICE = {"units": 2, "busy_s": 1.0, "window_s": 1.0}


def _span(name, ms, start_ms=0.0, **attrs):
    return SimpleNamespace(name=name, seconds=ms * 1e-3, attrs=attrs,
                           start_ns=int(start_ms * 1e6),
                           end_ns=int((start_ms + ms) * 1e6))


SESSION = [
    _span("frame", 90.0, hit_rays=500_000, chunks=31),
    _span("frame.probe", 1.0), _span("frame.hit_count", 60.0),
    _span("frame.chunks", 20.0), _span("frame.finish", 2.0),
    _span("frame", 80.0, hit_rays=490_000, chunks=30),
    _span("frame.hit_count", 50.0), _span("frame.chunks", 18.0),
    _span("frame.finish", 1.0),
    _span("fit.call", 0.4, steps=8), _span("fit.call", 0.2, steps=8),
    _span("distill.call", 3.0, steps=100)]
# a build inside the warm-up (on autograd's thread, say) is left out; one
# before it is not set-up of the graph's
SETUP = [_span("kernels.build", 100.0, 0.0, built=False),
         _span("graph.warmup", 4000.0, 200.0),
         _span("kernels.build", 1500.0, 1000.0, built=True),
         _span("graph.capture", 2500.0, 4300.0)]
EXPECTED = {"sync_wait_ms.frame": 55.0, "dispatch_ms.frame": 20.5,
            "hit_rays.frame": 495_000.0, "issue_ms.step": 3.6 / 116,
            "issue_ms.distill": 3.6 / 116, "capture_s.step": 5.0,
            "capture_s.distill": 5.0}


def test_the_new_metrics_list_their_cells():
    assert set(NEW) == set(EXPECTED)
    for metric in NEW.values():
        assert metric["workloads"], metric["name"]


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_an_empty_recorder(monkeypatch, name):
    monkeypatch.setattr(tracing, "latest", lambda: ([], []))
    reader = load_reader(name)
    assert reader.read(SLICE) is None
    monkeypatch.setattr(tracing, "latest", lambda: (SESSION, SETUP))
    assert reader.read({}) is None    # not a traced run


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_synthetic_session(monkeypatch, name):
    monkeypatch.setattr(tracing, "latest", lambda: (SESSION, SETUP))
    assert load_reader(name).read(SLICE) == pytest.approx(EXPECTED[name])


def _cell_metrics(workload, parts, device):
    return run_cell(BENCH, workload, 2 ** 31 + 5, 0.3, True, device, 0.0,
                    parts)["metrics"]


def _new_metrics_of(workload):
    return {name for name, m in NEW.items() if workload in m["workloads"]}


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_a_tiny_traced_cell_prints_its_span_metrics(workload):
    metrics = _cell_metrics(workload, tiny_parts(workload, BENCH), "cpu")
    # the CPU runs a chunk of steps eagerly: no graph, no capture
    expected = {n for n in _new_metrics_of(workload)
                if not n.startswith("capture_s.")}
    assert expected <= set(metrics), sorted(metrics)
    assert not any(n.startswith("capture_s.") for n in metrics)
    for name in expected:
        assert metrics[name]["value"] > 0.0
        assert metrics[name]["unit"] == NEW[name]["unit"]


@pytest.mark.parametrize("workload", ORBIT_CELLS)
def test_hit_rays_are_the_references_drawn_rays_and_the_face_rule(workload):
    """Each traced frame's ``hit_rays`` is the plain reference's count of
    the rays its culled frame draws, plus the 0-60 that the probe's face
    rule may add (ROADMAP.md, queue 3); the metric is their mean."""
    parts = tiny_parts(workload, HELD)
    cell = parts["kind"].Cell(parts["config"], parts["mix"], 2 ** 31 + 5,
                              torch.device("cpu"), parts["configs"])
    tracer = Tracer(True, "cpu")
    cell.setup()
    cell.window(0.3, tracer)
    frames = [s for s in tracing.latest()[0] if s.name == "frame"]
    hits = [s.attrs["hit_rays"] for s in frames]
    cell.release()
    trace = dict(tracer.summary(), **cell.counts())
    reference = cell.reference()
    assert len(hits) == len(cell.traced) == trace["units"]
    for camera, hit in zip(cell.traced, hits):
        assert 0 <= hit - reference.drawn(camera) <= 60, camera
    assert load_reader("hit_rays.frame").read(trace) == \
        pytest.approx(sum(hits) / len(hits))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_a_traced_cell_prints_its_span_metrics_on_a_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size runs the "
                    "program's kernels, which have no CPU mode")
    metrics = _cell_metrics(workload, cell_parts(BENCH, workload),
                            torch.device("cuda", 0))
    for name in _new_metrics_of(workload):
        assert metrics[name]["value"] > 0.0, name
