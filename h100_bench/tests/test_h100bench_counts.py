"""The frozen counts against PERF.md's bound arithmetic, and the readers'
arithmetic on a made-up trace."""

import json

import pytest

from h100_bench.counts.nerf import (encoding_macs, forward_flops,
                                    k1_bound_s, k2_bound_s, matmul_macs)
from h100_bench.spec import BENCH_DIR, load_reader
from h100_bench.trace import reduce_events


def _config(name):
    return json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name,macs", [("nerf-8x256", 593_408),
                                       ("nerf-6x192", 266_880)])
def test_macs_a_point(name, macs):
    cfg = _config(name)
    assert matmul_macs(cfg) == macs
    assert encoding_macs(cfg) == 126
    assert forward_flops(cfg) == 2 * (macs + 126)


def test_kernel_bounds_match_perf_md():
    flagship = _config("nerf-8x256")
    assert round(k1_bound_s(flagship, 786_432) * 1e3, 3) == 0.944
    assert round(k2_bound_s(flagship, 131_072) * 1e3, 2) == 0.47
    student = _config("nerf-6x192")
    assert round(k1_bound_s(student, 131_072) * 1e3, 4) == 0.0708
    assert round(k2_bound_s(student, 131_072) * 1e3, 3) == 0.212


def test_reduce_events_and_readers():
    device = [("fused_nerf_bf16_kernel<256>", 0.0, 600.0),
              ("elementwise", 600.0, 700.0),
              ("fused_nerf_backward_bf16_kernel<256>", 800.0, 1000.0)]
    host = [("aten::nonzero", 650.0, 900.0), ("outer", 0.0, 1000.0)]
    trace = reduce_events(device, host, window_s=1e-3)
    assert trace["busy_s"] == pytest.approx(900e-6)
    assert trace["gaps"] == [["aten::nonzero", pytest.approx(100e-6)]]
    trace.update(units=2, k1_bound_s=300e-6, k2_bound_s=50e-6,
                 window_model_flops=2e8, window_seconds=1e-3)
    assert load_reader("k1_roofline.step").read(trace) == pytest.approx(50.0)
    assert load_reader("k1_roofline.frame").read(trace) == \
        pytest.approx(50.0)
    assert load_reader("k2_roofline.step").read(trace) == pytest.approx(25.0)
    assert load_reader("busy_ms.step").read(trace) == pytest.approx(0.45)
    assert load_reader("other_device_ms.step").read(trace) == \
        pytest.approx(0.05)
    assert load_reader("mfu.step").read(trace) == \
        pytest.approx(100 * 2e8 / 1e-3 / 989e12)
    assert load_reader("mfu.frame").read(trace) == \
        pytest.approx(100 * 2e8 / 1e-3 / 989e12)


def test_a_reader_serves_its_family():
    assert load_reader("mfu.frame").__file__ == \
        load_reader("mfu.step").__file__ == str(BENCH_DIR / "metrics"
                                                / "mfu.py")


def test_readers_return_nothing_without_a_trace():
    empty = reduce_events([], [], window_s=1.0)
    empty.update(units=3, k1_bound_s=1.0, k2_bound_s=1.0)
    for name in ("k1_roofline.frame", "k2_roofline.step", "busy_ms.frame",
                 "other_device_ms.frame", "mfu.step"):
        assert load_reader(name).read(empty) is None
