"""The span recorder (``utils/tracing.py``) and the spans the port records
in its frame, its train and distill steps and ``utils.debug.profile``:
off by default, on under a ``torch.profiler`` session of the calling
thread, sessions kept apart, set-up spans always, spans of other threads
put on the profile's clock, and the device's idle gaps put under the
spans covering them."""

import json
import math
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from fourier_feature_nets_torch.cameras import Resolution
from fourier_feature_nets_torch.datasets import ImageDataset
from fourier_feature_nets_torch.datasets.synthetic import (
    generate_synthetic_dataset,
)
from fourier_feature_nets_torch.models import NeRF
from fourier_feature_nets_torch.render import (
    OccupancyGridSampler,
    Raycaster,
    RaySampler,
)
from fourier_feature_nets_torch.render.distill import distill
from fourier_feature_nets_torch.utils import debug, tracing
from fourier_feature_nets_torch.utils.camera_paths import orbit

SMALL = dict(num_layers=2, num_channels=16, max_log_scale_pos=3.0,
             num_freq_pos=4, max_log_scale_view=1.0, num_freq_view=2,
             skips=[], include_inputs=True)
BOUNDS = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
# a span's start on the profile's clock, against its profiler event
CLOCK_US = 1000.0


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _named(spans, name):
    return [s for s in spans if s.name == name]


def test_off_records_nothing(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    assert not torch.autograd._profiler_enabled()
    with tracing.span("test.off", rays=3) as off:
        off.set(chunks=1)
    assert not any(s.name == "test.off" for s in tracing._spans)
    assert opened == []


def _ops(prof, name):
    return [e for e in prof.events() if e.name == name]


def test_spans_nest_on_the_profiles_clock():
    with _cpu_profile() as prof:
        with tracing.span("test.outer", steps=2) as outer:
            with tracing.span("test.inner"):
                torch.ones(8).sum()
            outer.set(chunks=1)
    spans, _ = tracing.latest()
    assert [s.name for s in spans] == ["test.outer", "test.inner"]
    outer, inner = spans
    assert outer.attrs == {"steps": 2, "chunks": 1}
    assert inner.parent == outer.id and outer.parent is None
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    # a span is no profiler range
    assert not [e for e in prof.events()
                if getattr(e, "is_user_annotation", False)]
    rows = {name: (start, end)
            for name, start, end, _ in tracing.profile_spans(prof)}
    total, = _ops(prof, "aten::sum")
    for name in ("test.outer", "test.inner"):
        start, end = rows[name]
        assert start - CLOCK_US <= total.time_range.start
        assert total.time_range.end <= end + CLOCK_US


def test_a_session_opened_before_its_profile_lands_on_its_clock():
    """The pair of clocks that a session reads before the profile starts
    still puts its spans on the profile's clock."""
    with tracing.record_all_threads() as session:
        with _cpu_profile() as prof:
            with tracing.span("test.early"):
                torch.ones(8).sum()
    (name, start, end, _), = tracing.profile_spans(prof, session)
    total, = _ops(prof, "aten::sum")
    assert start - CLOCK_US <= total.time_range.start
    assert total.time_range.end <= end + CLOCK_US


def test_setup_spans_are_recorded_while_off():
    assert not torch.autograd._profiler_enabled()
    with tracing.setup_span("test.setup", source="x.cu") as setup:
        setup.set(built=False)
    recorded = _named(tracing._spans, "test.setup")[-1]
    assert recorded.setup and recorded.session is None
    assert recorded.attrs == {"source": "x.cu", "built": False}
    assert recorded in tracing.latest()[1]


def test_sessions_stay_apart():
    with tracing.setup_span("test.setup_before"):
        pass
    with _cpu_profile():
        with tracing.span("test.first"):
            pass
    with tracing.span("test.between"):     # off: ends the session
        pass
    with tracing.setup_span("test.setup_between"):
        pass
    with _cpu_profile():
        with tracing.span("test.second"):
            with tracing.setup_span("test.setup_inside"):
                pass
    spans, setup = tracing.latest()
    assert [s.name for s in spans] == ["test.second", "test.setup_inside"]
    assert [s.name for s in setup] == ["test.setup_between",
                                       "test.setup_inside"]
    first = _named(tracing._spans, "test.first")[-1]
    assert first.session is not spans[0].session
    assert not _named(tracing._spans, "test.between")


def test_profile_puts_spans_of_two_threads_on_one_clock(tmp_path):
    def worker():
        with tracing.span("test.worker", request=7):
            torch.ones(16).sum()

    with debug.profile(str(tmp_path)):
        with tracing.span("test.main"):
            torch.ones(32).sum()
            thread = threading.Thread(target=worker)
            thread.start()
            thread.join(timeout=60)
    assert not thread.is_alive()
    with open(tmp_path / "trace.json") as handle:
        events = json.load(handle)["traceEvents"]
    main, = [e for e in events if e.get("name") == "test.main"]
    ours, = [e for e in events if e.get("name") == "test.worker"]
    assert main["cat"] == ours["cat"] == "program_span"
    assert ours["args"]["request"] == 7 and ours["tid"] != main["tid"]
    assert ours["args"]["parent"] is None
    # the profiler's operators of the main thread lie inside its span
    ops = [e for e in events if e.get("name") == "aten::ones"
           and e.get("tid") == main["tid"]]
    assert ops
    for inner in ops + [ours]:
        assert main["ts"] - CLOCK_US <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= main["ts"] + main["dur"] \
            + CLOCK_US


def _event(name, start, end, device=DeviceType.CPU, annotation=False):
    return SimpleNamespace(name=name, device_type=device,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def test_idle_by_span_on_synthetic_events():
    cuda = DeviceType.CUDA
    events = [
        _event("k1", 0.0, 100.0, cuda), _event("k2", 150.0, 200.0, cuda),
        _event("k3", 180.0, 210.0, cuda), _event("k4", 400.0, 500.0, cuda),
        _event("k5", 900.0, 1000.0, cuda),
        # a host range's shadow on the device is no work of the device's
        _event("range", 0.0, 1000.0, cuda, annotation=True),
        _event("aten::nonzero", 100.0, 160.0)]
    spans = [("frame", 0.0, 650.0, None),
             ("frame.hit_count", 100.0, 160.0, None)]
    assert tracing.idle_by_span(events, spans) == {
        "frame.hit_count": pytest.approx(0.05),
        "frame": pytest.approx(0.19),
        tracing.CALLER: pytest.approx(0.4)}
    assert tracing.idle_by_span(events, [("frame.chunks", 350.0, 950.0)]) \
        == {tracing.CALLER: pytest.approx(0.24),
            "frame.chunks": pytest.approx(0.4)}
    assert tracing.idle_by_span([_event("aten::mm", 0.0, 5.0)], spans) == {}


@pytest.fixture(scope="module")
def frame_parts():
    torch.manual_seed(0)
    model = NeRF(**SMALL)
    cameras = orbit(np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0]),
                    3, 40.0, Resolution(24, 24), 3.0)
    grid = (np.random.default_rng(0).uniform(size=(8, 8, 8)) < 0.3)
    sampler = OccupancyGridSampler(grid.astype(np.float32), 1.0, cameras,
                                   8, probe_resolution=4, bounds=BOUNDS)
    return Raycaster(model), sampler


@pytest.mark.parametrize("early_term", [0.0, 0.5])
def test_frame_spans_carry_its_counts(frame_parts, early_term):
    raycaster, sampler = frame_parts
    chunk = 32
    # untraced, as a caller warms up: the traced frame's first span then
    # opens a session of its own
    raycaster.render_frame_async(sampler, 0, chunk_size=chunk)
    with _cpu_profile() as prof:
        raycaster.render_frame_async(sampler, 1, chunk_size=chunk,
                                     probe_subsample=1,
                                     early_term=early_term)
    spans, _ = tracing.latest()
    frame, = _named(spans, "frame")
    hit = raycaster.frame_rays["hit"]
    assert 0 < hit < sampler.rays_per_camera
    chunks = math.ceil(hit / chunk)
    if early_term:
        chunks += math.ceil(raycaster.frame_rays["survived"] / chunk)
    assert frame.attrs == {"hit_rays": hit, "chunks": chunks}
    children = [s for s in spans if s.parent == frame.id]
    passes = 2 if early_term else 1
    assert [s.name for s in children] == (
        ["frame.probe", "frame.hit_count"]
        + ["frame.chunks", "frame.hit_count"] * (passes - 1)
        + ["frame.chunks", "frame.finish"])
    groups = {s.id for s in children if s.name == "frame.chunks"}
    assert len([s for s in spans if s.parent in groups
                and s.name == "frame.chunk"]) == chunks
    rows = {name: (start, end)
            for name, start, end, _ in tracing.profile_spans(prof)}
    nonzero = _ops(prof, "aten::nonzero")
    assert len(nonzero) == passes
    start, end = rows["frame"]
    for op in nonzero:
        assert start - CLOCK_US <= op.time_range.start
        assert op.time_range.end <= end + CLOCK_US


def test_a_profiled_frame_holds_its_operators(frame_parts, tmp_path):
    raycaster, sampler = frame_parts
    with debug.profile(str(tmp_path)):
        raycaster.render_frame_async(sampler, 0, chunk_size=64,
                                     probe_subsample=1)
    with open(tmp_path / "trace.json") as handle:
        events = json.load(handle)["traceEvents"]
    frame, = [e for e in events if e.get("name") == "frame"]
    probe, = [e for e in events if e.get("name") == "frame.probe"]
    assert frame["cat"] == probe["cat"] == "program_span"
    assert probe["args"]["parent"] == frame["args"]["id"]
    nonzero = [e for e in events if e.get("name") == "aten::nonzero"]
    assert nonzero and frame["tid"] == nonzero[0]["tid"]
    for inner in [probe] + nonzero:
        assert frame["ts"] - CLOCK_US <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= frame["ts"] + frame["dur"] \
            + CLOCK_US


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scene") / "scene.npz")
    return generate_synthetic_dataset(path, resolution=16,
                                      split_counts=(3, 1, 1),
                                      volume_side=16, num_samples=64)


def test_fit_leaves_a_span_a_call(scene):
    torch.manual_seed(0)
    raycaster = Raycaster(NeRF(**SMALL))
    train = ImageDataset.load(scene, "train", 8)
    val = ImageDataset.load(scene, "val", 8)
    with _cpu_profile():
        raycaster.fit(train, val, 32, 1e-3, num_steps=7, crop_steps=0,
                      report_interval=100, decay_rate=0.1,
                      decay_steps=100, steps_per_call=3)
    spans, _ = tracing.latest()
    calls = _named(spans, "fit.call")
    assert [s.attrs["steps"] for s in calls] == raycaster.call_steps
    assert len(calls) == 3 and all(s.seconds > 0 for s in calls)


def test_distill_leaves_a_span_a_call_and_report():
    torch.manual_seed(0)
    cameras = orbit(np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0]),
                    3, 40.0, Resolution(16, 16), 3.0)
    sampler = RaySampler(BOUNDS, cameras, 8, stratified=True)
    reports = []
    with _cpu_profile():
        distill(NeRF(**SMALL), NeRF(**SMALL), sampler, num_steps=7,
                batch_rays=16, steps_per_call=3, fused_teacher=False,
                fused_student=False, report_interval=3,
                reporter=lambda step, loss: reports.append(step))
    spans, _ = tracing.latest()
    assert [s.attrs["steps"] for s in _named(spans, "distill.call")] \
        == [3, 3, 1]
    assert len(_named(spans, "distill.report")) == len(reports) == 3
