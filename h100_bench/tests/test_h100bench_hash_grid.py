"""Instant-NGP's family: its frozen counts at the published widths, and
the hash encoding's readers on a made-up trace."""

import json

import pytest

from h100_bench.counts import hash_grid as counts
from h100_bench.families import hash_grid as family
from h100_bench.spec import BENCH_DIR, load_reader
from h100_bench.trace import reduce_events

POINTS = 262_144


def _config():
    return json.loads((BENCH_DIR / "configs" / "instant-ngp.json")
                      .read_text())


def test_counts_at_the_published_widths():
    cfg = _config()
    assert counts.table_rows(cfg) == 6_098_120
    assert counts.matmul_macs(cfg) == 9_408
    assert counts.interpolation_macs(cfg) == 256
    assert counts.forward_flops(cfg) == 2 * (9_408 + 256)
    assert counts.step_flops(cfg) == 3 * counts.forward_flops(cfg)
    specs = family.leaf_specs(cfg)
    assert specs[0] == ("table", (6_098_120, 2), 1e-4)
    assert [name for name, _, _ in specs[1:]] == [
        "density.0.weight", "density.1.weight", "color.0.weight",
        "color.1.weight", "color.2.weight"]
    assert sum(shape[0] * shape[1] for _, shape, _ in specs[1:]) == 9_408


@pytest.mark.parametrize("dtype,moved", [("bfloat16", 137_415_808),
                                         ("float32", 170_970_240)])
def test_compulsory_bytes_of_a_step(dtype, moved):
    """Forward: 12 B of position and the features at their stored width
    a point, every table row once; backward: the features' gradient and
    the positions a point, the table's gradient once."""
    cfg = dict(_config(), compute_dtype=dtype)
    table = 6_098_120 * 2 * 4
    feature = 32 * (2 if dtype == "bfloat16" else 4)
    assert counts.pass_bytes(cfg, POINTS) == POINTS * (12 + feature) + table
    assert 2 * counts.pass_bytes(cfg, POINTS) == moved
    assert counts.step_bounds(cfg, POINTS)["hash_bound_s"] == \
        pytest.approx(moved / 3.35e12)
    assert counts.forward_bounds(cfg, POINTS)["hash_bound_s"] == \
        pytest.approx(moved / 2 / 3.35e12)


def test_hash_readers_on_a_trace():
    device = [("void (anonymous namespace)::hash_grid_encode_kernel<"
               "__nv_bfloat16>(...)", 0.0, 100.0),
              ("elementwise", 100.0, 400.0),
              ("void (anonymous namespace)::hash_grid_backward_kernel<"
               "__nv_bfloat16>(...)", 400.0, 700.0)]
    trace = reduce_events(device, [], window_s=1e-3)
    trace.update(units=2, hash_bound_s=100e-6)
    assert load_reader("hash_roofline.step").read(trace) == \
        pytest.approx(25.0)
    assert load_reader("hash_ms.step").read(trace) == pytest.approx(0.2)


def test_hash_readers_without_hash_kernels():
    nerf = reduce_events([("fused_nerf_bf16_kernel<256>", 0.0, 600.0)], [],
                         window_s=1e-3)
    nerf.update(units=3, hash_bound_s=1e-4, k1_bound_s=1e-4)
    empty = reduce_events([], [], window_s=1.0)
    empty.update(units=3, hash_bound_s=1e-4)
    for trace in (nerf, empty):
        assert load_reader("hash_roofline.step").read(trace) is None
        assert load_reader("hash_ms.step").read(trace) is None
