"""Readings of a cell's compared numbers, for setting its limits.

    python3 h100_bench/readings.py --workload train-8x256 --seeds 1,2,3 --seconds 2 [--control]

For each seed, in one process: the cell's set-up, a window of
``--seconds`` at the cell's own sizes and load, and the check's numbers
(the program's, the lower readings). With ``--control`` also the
control's, the plain reference put in the program's place in fp8 (the
upper readings), and for a training cell the planted fault of a loss
taken over half the batch. One JSON line a seed. The benchmark's own
runs never run this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import contextlib

    import torch

    from h100_bench.spec import cell_parts, load_benchmark
    from h100_bench.trace import Tracer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parts = cell_parts(load_benchmark(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        start = time.perf_counter()
        cell = parts["kind"].Cell(parts["config"], parts["mix"], seed,
                                  torch.device(args.device),
                                  parts["configs"])
        with contextlib.redirect_stdout(sys.stderr):
            cell.setup()
            cell.window(args.seconds, Tracer(False, args.device))
            cell.release()
            gc.collect()
            row = {"workload": args.workload, "seed": seed}
            if args.control:
                row.update(cell.control())
            else:
                row["program"] = {c.name: c.value
                                  for c in cell.check(parts["limits"])}
        row["seconds"] = time.perf_counter() - start
        print(json.dumps(row), flush=True)
        del cell
        gc.collect()
        if torch.device(args.device).type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
