"""Tiny versions of the benchmark's cells, for runs on the CPU: each
kind's mix is cut by its module's ``TINY`` (``kinds/<kind>.py``; a
nested group merges into the mix's group of that name), each
configuration by its family's (``families/<model>.py``)."""

import copy

from h100_bench.families import family
from h100_bench.spec import cell_parts, load_benchmark

# Cells whose kind, mix and limits are kept but which BENCHMARK.json does
# not run: a served frame's time, and a sparse frame's, move with the host
# by more than any bound allows (PERF.md, section 7). The tests keep their
# kinds sound.
HELD_OUT = [{"name": "serve-6x192", "config": "nerf-6x192",
             "traffic": "serve-pose-4clients", "chips": 1},
            {"name": "orbit-8x256-sparse", "config": "nerf-8x256",
             "traffic": "orbit-sparse", "chips": 1}]


def with_held_out(bench: dict) -> dict:
    """``bench`` with the held-out cells among its workloads."""
    return dict(bench, workloads=bench["workloads"] + HELD_OUT)


def _laid_over(mix: dict, tiny: dict) -> dict:
    out = copy.deepcopy(mix)
    for key, value in tiny.items():
        out[key] = (_laid_over(out.get(key, {}), value)
                    if isinstance(value, dict) else value)
    return out


def tiny_parts(workload: str, bench=None) -> dict:
    """The cell's parts with every model and input cut to a CPU's size;
    its limits are the cell's own."""
    parts = cell_parts(bench or load_benchmark(), workload)
    parts = dict(parts, configs={name: dict(cfg, **family(cfg).TINY)
                                 for name, cfg in parts["configs"].items()})
    parts["config"] = parts["configs"][parts["entry"]["config"]]
    parts["mix"] = _laid_over(parts["mix"], parts["kind"].TINY)
    return parts
