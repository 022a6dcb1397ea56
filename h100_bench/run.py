"""Runs one cell of the benchmark once and prints its result line.

    python3 h100_bench/run.py --workload orbit-8x256 --seed 7 --seconds 20 --trace 0

From the root of a checkout, on a machine with the cell's CUDA cards.
With ``--trace 0`` the last line of standard output is the JSON result
with the cell's end-to-end metrics; with ``--trace 1`` a slice of the
same work runs under ``torch.profiler`` and the line holds the cell's
per-layer metrics, the device's busy and window seconds and a
breakdown. Every line the program prints goes to standard error.

A run: set-up (seeded weights on the device, the cell's inputs, the
program's warm-up) -> the measured window -> the device's memory peak
-> the program's state freed -> the check against the plain reference,
each number compared printed beside its limit on standard error and
under ``checks``, the result's last key. ``setup_s`` runs from the
process's start to the window's.
"""

import time

_CLOCK_AT_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

FORBIDDEN = ("jax", "jaxlib", "flax", "fourier_feature_nets_tpu")


def _process_age() -> float:
    """Seconds from the process's start to this module's import."""
    try:
        with open("/proc/self/stat") as handle:
            fields = handle.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as handle:
            uptime = float(handle.read().split()[0])
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return max(0.0, uptime - started - (time.perf_counter()
                                            - _CLOCK_AT_IMPORT))
    except (OSError, ValueError, IndexError):
        return 0.0


def _forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def _cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = Path(__file__).resolve().parent / "_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("USE_FLAX", "0")


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device, started: float, parts=None) -> dict:
    """Runs the cell; returns its result (without ``device``'s card
    fields) and its checks. ``started`` is the process's start on the
    ``time.perf_counter`` clock; ``parts`` replaces the cell's parts
    (:func:`~h100_bench.spec.cell_parts`)."""
    import torch

    from h100_bench.spec import cell_parts, load_reader, per_layer_for
    from h100_bench.trace import Tracer

    parts = parts or cell_parts(bench, workload)
    cell = parts["kind"].Cell(parts["config"], parts["mix"], seed, device,
                              parts["configs"])
    on_cuda = torch.device(device).type == "cuda"
    tracer = Tracer(trace, device)
    with contextlib.redirect_stdout(sys.stderr):
        built = time.perf_counter()
        cell.setup()
        ready = time.perf_counter()
        out = cell.window(seconds, tracer)
        print(f"set-up: {built - started:.3f} s to the cell's start "
              f"(imports, the device), {ready - built:.3f} s its set-up, "
              f"{out['start'] - ready:.3f} s to the window", file=sys.stderr)
        peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
        cell.release()
        gc.collect()
        if on_cuda:
            torch.cuda.empty_cache()
        checks = cell.check(parts["limits"])
    result = {"correct": out["failed"] == 0 and all(c.passed
                                                    for c in checks),
              "attempted": out["attempted"], "failed": out["failed"]}
    device_info = {"memory_peak_bytes": int(peak)}
    for name, (value, unit) in out["metrics"].items():
        print(f"window {name}: {value!r} {unit}", file=sys.stderr)
    if trace:
        summary = tracer.summary()
        slice_ = dict(summary, **cell.counts())
        metrics = {}
        for metric in per_layer_for(bench, workload):
            value = load_reader(metric["name"]).read(slice_)
            if value is not None:
                metrics[metric["name"]] = {"value": value,
                                           "unit": metric["unit"]}
        device_info.update(busy_s=summary.get("busy_s", 0.0),
                           window_s=summary.get("window_s", 0.0))
        result["metrics"] = metrics
        result["device"] = device_info
        result["breakdown"] = {"device_ops": summary.get("top", []),
                               "idle_gaps": summary.get("gaps", [])}
    else:
        metrics = {name: {"value": value if math.isfinite(value) else None,
                          "unit": unit}
                   for name, (value, unit) in out["metrics"].items()}
        metrics["setup_s"] = {"value": out["start"] - started, "unit": "s"}
        result["metrics"] = metrics
        result["device"] = device_info
    # a number that is not finite failed; JSON has no spelling for it
    result["checks"] = {c.name: {"value": c.value if math.isfinite(c.value)
                                 else None, "limit": c.limit}
                        for c in checks}
    return result


def main(argv=None) -> int:
    started = _CLOCK_AT_IMPORT - _process_age()
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _cache_dirs()

    import torch

    from h100_bench.spec import load_benchmark

    bench = load_benchmark()
    entry = [w for w in bench["workloads"] if w["name"] == args.workload]
    if not entry:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < entry[0]["chips"]:
        print(f"{args.workload} needs {entry[0]['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), started)
    found = _forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark measures "
              f"the PyTorch port alone", file=sys.stderr)
        return 4
    checks = result.pop("checks")
    result["device"] = dict(platform="gpu",
                            kind=torch.cuda.get_device_name(0),
                            count=entry[0]["chips"], **result["device"])
    result["checks"] = checks
    for name, check in checks.items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
