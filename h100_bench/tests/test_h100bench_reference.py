"""The plain reference against the program's CPU path at a tiny size.

In f32 the two compute the same function, so the checks' numbers read
(nearly) nothing; the program's bf16 path on the CPU reads a little."""

import numpy as np
import pytest
import torch

from h100_bench.families import family
from h100_bench.reference.geometry import uniform_keyed
from h100_bench.run import run_cell
from h100_bench.spec import load_benchmark
from h100_bench.tests.tiny import tiny_parts, with_held_out
from h100_bench.weights import seeded_flat

BENCH = with_held_out(load_benchmark())
SEED = 2 ** 31 + 77


def _f32(parts):
    parts["configs"] = {name: dict(cfg, compute_dtype="float32")
                        for name, cfg in parts["configs"].items()}
    parts["config"] = parts["configs"][parts["entry"]["config"]]
    return parts


def test_plain_model_matches_the_program_model():
    parts = tiny_parts("orbit-8x256")
    cfg = parts["config"]
    flat = seeded_flat(cfg, torch.Generator().manual_seed(3), "cpu")
    program = family(cfg).program(cfg, flat, "cpu")
    plain = family(cfg).reference(cfg, flat, "cpu")
    rng = np.random.default_rng(0)
    pos = torch.from_numpy(rng.uniform(-1, 1, (257, 3)).astype(np.float32))
    views = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(257, 3)).astype(np.float32)), dim=-1)
    with torch.no_grad():
        torch.testing.assert_close(plain(pos, views), program(pos, views),
                                   rtol=1e-5, atol=1e-6)


def test_keyed_uniforms_match_the_program_generator():
    from fourier_feature_nets_torch.ops.sampling import per_ray_uniform
    ids = torch.arange(0, 50_000, 37)
    for key, step, salt in ((0, 0, 0), (2 ** 31 + 5, 1999, 2),
                            (20080524, 7, 4)):
        assert torch.equal(uniform_keyed(key, step, ids, 5, salt),
                           per_ray_uniform(key, step, ids, 5, salt=salt))


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_f32_program_agrees_with_the_reference(workload):
    result = run_cell(BENCH, workload, SEED, 0.3, False, "cpu", 0.0,
                      _f32(tiny_parts(workload, BENCH)))
    assert result["correct"], result["checks"]
    for name, check in result["checks"].items():
        assert check["value"] <= 1e-3 * max(check["limit"], 1.0), name


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_bf16_program_is_correct_at_a_tiny_size(workload):
    result = run_cell(BENCH, workload, SEED + 1, 0.3, False, "cpu", 0.0,
                      tiny_parts(workload, BENCH))
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
