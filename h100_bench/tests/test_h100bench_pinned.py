"""Pins what the accepted cells draw and count, as the harness read them
before model families were found by name: the seeded vector on a CPU
generator, the leaves' names and shapes, and the frozen counts. A change
here moves the cells' numbers."""

import hashlib
import json

import pytest
import torch

from h100_bench.families import family
from h100_bench.spec import BENCH_DIR
from h100_bench.weights import seeded_flat

SEED = 7
POINTS = 131_072
FIRST = [0.008799652568995953, -0.07589446008205414, 0.04011757671833038,
         0.039532631635665894, -0.0673377588391304, -0.01888275146484375,
         -0.07380738109350204, 0.032690491527318954]
PINNED = {
    "nerf-8x256": {
        "size": 595_844,
        "first": FIRST,
        "last": [0.06885083019733429, -0.019232839345932007,
                 -0.06612333655357361, 0.029556572437286377,
                 0.056415706872940063, -0.01518314890563488,
                 0.020628079771995544, 0.0366070456802845],
        "sum": 29.227289075200588,
        "sha256": "167a87525bd738784b48184cfaef4a79"
                  "70a25fd4c8e965d1b513d47d62d3eb42",
        "body": [(63, 256), (256, 256), (256, 256), (256, 256), (319, 256),
                 (256, 256), (256, 256), (256, 256)],
        "heads": [(256, 1), (256, 256), (283, 128), (128, 3)],
        "forward_flops": 1_187_068,
        "k1_bound_s": 0.00015732191799393326,
        "k2_bound_s": 0.0004719657539817998},
    "nerf-6x192": {
        "size": 268_324,
        "first": FIRST,
        "last": [-0.08717850595712662, -0.09859897941350937,
                 -0.0573197640478611, 0.04750790074467659,
                 -0.008884171023964882, 0.006001102272421122,
                 -0.07003600895404816, 0.025560559704899788],
        "sum": 15.943264820767325,
        "sha256": "d1bc7abcda12f8ea4e9e36496e3057e0"
                  "16fbef91e6bf6121d360dae7af577a8f",
        "body": [(63, 192), (192, 192), (192, 192), (255, 192), (192, 192),
                 (192, 192)],
        "heads": [(192, 1), (192, 192), (219, 96), (96, 3)],
        "forward_flops": 534_012,
        "k1_bound_s": 7.077251856825076e-05,
        "k2_bound_s": 0.00021231755570475227},
}
HEADS = ["opacity_out", "bottleneck", "hidden_view", "color_out"]


def _config(name):
    return json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())


def _leaves(pinned):
    """[(name, shape, bound)] of every weight (out, in) and bias, in
    order, each drawn from U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    names = [f"layers.{i}" for i in range(len(pinned["body"]))] + HEADS
    out = []
    for name, (fan_in, fan_out) in zip(names,
                                        pinned["body"] + pinned["heads"]):
        out += [(f"{name}.weight", (fan_out, fan_in), fan_in ** -0.5),
                (f"{name}.bias", (fan_out,), fan_in ** -0.5)]
    return out


@pytest.mark.parametrize("name", sorted(PINNED))
def test_seeded_vector_is_pinned(name):
    pinned, cfg = PINNED[name], _config(name)
    flat = seeded_flat(cfg, torch.Generator().manual_seed(SEED), "cpu")
    assert flat.dtype == torch.float32 and flat.numel() == pinned["size"]
    assert flat[:8].tolist() == pinned["first"]
    assert flat[-8:].tolist() == pinned["last"]
    assert float(flat.double().sum()) == pytest.approx(pinned["sum"],
                                                       rel=0, abs=1e-9)
    assert hashlib.sha256(flat.numpy().tobytes()).hexdigest() == \
        pinned["sha256"]


@pytest.mark.parametrize("name", sorted(PINNED))
def test_leaves_are_pinned(name):
    cfg = _config(name)
    specs = family(cfg).leaf_specs(cfg)
    assert [(n, tuple(shape), bound) for n, shape, bound in specs] == \
        _leaves(PINNED[name])


@pytest.mark.parametrize("name", sorted(PINNED))
def test_counts_are_pinned(name):
    pinned, cfg = PINNED[name], _config(name)
    counts = family(cfg).counts
    assert counts.forward_flops(cfg) == pinned["forward_flops"]
    assert counts.step_flops(cfg) == 3 * pinned["forward_flops"]
    assert counts.k1_bound_s(cfg, POINTS) == pinned["k1_bound_s"]
    assert counts.k2_bound_s(cfg, POINTS) == pinned["k2_bound_s"]
    assert counts.forward_bounds(cfg, POINTS) == {
        "k1_bound_s": pinned["k1_bound_s"]}
    assert counts.step_bounds(cfg, POINTS) == {
        "k1_bound_s": pinned["k1_bound_s"],
        "k2_bound_s": pinned["k2_bound_s"]}
