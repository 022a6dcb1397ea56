"""Tiny versions of the benchmark's cells, for runs on the CPU."""

import copy

from h100_bench.spec import cell_parts, load_benchmark

TINY_MODEL = {"num_layers": 2, "num_channels": 32, "skips": [1],
              "num_freq_pos": 4, "max_log_scale_pos": 3.0,
              "num_freq_view": 2, "max_log_scale_view": 1.0}
TINY_OCCUPANCY = {"resolution": 8, "probe_resolution": 4}
TINY_MIX = {
    "orbit": {"resolution": 24, "num_cameras": 4, "num_samples": 8,
              "chunk_size": 64, "check_frames": 2, "trace_frames": 3},
    "serve": {"resolution": 24, "num_cameras": 4, "num_samples": 8,
              "chunk_size": 64, "pose_count": 64, "clients": 4,
              "drain_seconds": 60.0, "check_requests": 2,
              "trace_seconds": 0.5},
    "train": {"batch_size": 64, "num_samples": 8, "steps_per_call": 4,
              "trace_calls": 2},
    "distill": {"resolution": 16, "num_cameras": 4, "num_samples": 8,
                "batch_rays": 32, "steps_per_call": 4, "report_interval": 4,
                "trace_calls": 2},
}
TINY_SCENE = {"resolution": 16, "split_counts": [3, 1, 1], "num_cameras": 5,
              "volume_side": 16, "march_samples": 32}
# Cells whose kind, mix and limits are kept but which BENCHMARK.json does
# not run: a served frame's time moves with the host by more than any
# bound allows (PERF.md, section 7). The tests keep their drivers sound.
HELD_OUT = [{"name": "serve-6x192", "config": "nerf-6x192",
             "traffic": "serve-pose-4clients", "chips": 1}]


def with_held_out(bench: dict) -> dict:
    """``bench`` with the held-out cells among its workloads."""
    return dict(bench, workloads=bench["workloads"] + HELD_OUT)


def tiny_parts(workload: str, bench=None) -> dict:
    """The cell's parts with every model and input cut to a CPU's size;
    its limits are the cell's own."""
    parts = cell_parts(bench or load_benchmark(), workload)
    parts = dict(parts, configs={name: dict(cfg, **TINY_MODEL)
                                 for name, cfg in parts["configs"].items()})
    parts["config"] = parts["configs"][parts["entry"]["config"]]
    mix = copy.deepcopy(parts["mix"])
    mix.update(TINY_MIX[mix["kind"]])
    if "occupancy" in mix:
        mix["occupancy"].update(TINY_OCCUPANCY)
    if "scene" in mix:
        mix["scene"].update(TINY_SCENE)
    parts["mix"] = mix
    return parts
