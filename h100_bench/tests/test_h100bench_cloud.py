"""The orbit kind's occupancy sources: the point cloud that the harness
rasterises, handed alike to the program's sampler and the reference's
``Occupancy``, and the model's own density when a mix names none."""

import copy

import numpy as np
import pytest
import torch

from h100_bench.families import family
from h100_bench.kinds.orbit import (FrameReference, cameras_of,
                                    program_sampler, reference_grid)
from h100_bench.reference.geometry import density_grid
from h100_bench.spec import load_benchmark
from h100_bench.tests.tiny import tiny_parts, with_held_out
from h100_bench.traffic.generator import cloud_grid, orbit_rig
from h100_bench.weights import seeded_flat

BENCH = with_held_out(load_benchmark())
CLOUD_CELLS = [w["name"] for w in BENCH["workloads"]
               if tiny_parts(w["name"], BENCH)["mix"].get("occupancy", {})
               .get("source") == "cloud"]


def test_a_cell_uses_the_cloud():
    assert "orbit-8x256-sparse" in CLOUD_CELLS


def test_cloud_grid_counts_points_a_cell():
    occupancy = {"cloud": {"seed": 3, "points": 500, "mean": [0.2, 0.0, -0.1],
                           "sigma": 0.5},
                 "min_points": 2, "resolution": 6}
    scale = 1.5
    points = np.random.default_rng(3).normal(
        [0.2, 0.0, -0.1], 0.5, (500, 3)).astype(np.float32)
    counts = np.zeros((6, 6, 6), np.int64)
    for x, y, z in points:
        cell = [int(np.floor((c / np.float32(scale) + 1.0) * 0.5 * 6))
                for c in (x, y, z)]
        if all(0 <= c < 6 for c in cell):
            counts[cell[2], cell[1], cell[0]] += 1
    grid = cloud_grid(occupancy, scale)
    assert grid.dtype == np.float32 and grid.shape == (6, 6, 6)
    np.testing.assert_array_equal(grid, (counts >= 2).astype(np.float32))
    assert 0 < grid.sum() < grid.size


def _sides(workload, mix=None):
    parts = tiny_parts(workload, BENCH)
    mix = mix or parts["mix"]
    cfg = parts["config"]
    flat = seeded_flat(cfg, torch.Generator().manual_seed(5), "cpu")
    k, e = orbit_rig(mix)
    sampler = program_sampler(family(cfg).program(cfg, flat, "cpu"), mix,
                              cameras_of(k, e, mix["resolution"]), "cpu")
    reference = FrameReference(cfg, flat, mix, k, e, "cpu")
    return mix, sampler, reference


@pytest.mark.parametrize("workload", CLOUD_CELLS)
def test_program_and_reference_read_one_cloud_grid(workload):
    mix, sampler, reference = _sides(workload)
    grid = torch.from_numpy(cloud_grid(mix["occupancy"], mix["box_scale"]))
    assert torch.equal(sampler.occupancy, grid)
    table = reference.occupancy.table
    assert table.shape[0] == sampler._probe_resolution
    assert torch.equal(sampler.probe_table, table.reshape(-1))
    assert torch.equal(reference_grid(None, mix, "cpu"), grid)


def test_a_mix_without_a_source_reads_the_models_density():
    mix, sampler, reference = _sides("orbit-8x256")
    assert "source" not in mix["occupancy"]
    occ = mix["occupancy"]
    grid = density_grid(reference.model, occ["resolution"],
                        mix["box_scale"], occ["alpha_threshold"])
    assert torch.equal(reference_grid(reference.model, mix, "cpu"), grid)
    assert torch.equal(sampler.occupancy, grid)


def test_an_unknown_source_is_refused():
    mix = copy.deepcopy(tiny_parts("orbit-8x256-sparse", BENCH)["mix"])
    mix["occupancy"]["source"] = "tree"
    with pytest.raises(ValueError, match="occupancy source"):
        reference_grid(None, mix, "cpu")
    with pytest.raises(ValueError, match="occupancy source"):
        program_sampler(None, mix, [], "cpu")
