"""CLI: hyperparameter sweep runner.

Port of ``fourier_feature_nets_tpu/cli/sweep.py``, same flags: the
search of :mod:`..utils.search` (a NumPy GP / expected-improvement
optimizer, a copy of the JAX package's) over a multi-dimensional space,
up to ``--max-concurrent`` trainer subprocesses at a time (constant-liar
batching keeps concurrent suggestions apart), each one of the port's
trainers (``python -m fourier_feature_nets_torch.cli.<trainer>``, the
package importable from any working directory), scored by the best value
of ``--metric`` in its ``log.txt``. Concurrent trainers on one card
share it. Pass ``--device cpu`` among the trainer's arguments to train
on the CPU.

Strategies:
- ``grid``      one run per value of ``--param``/``--values``
- ``random``    ``--max-runs`` random draws from ``--space``
- ``bayesian``  GP + EI over ``--space``

Examples:
  # grid A/B over one flag
  python -m fourier_feature_nets_torch.cli.sweep train_tiny_nerf \\
      --param learning-rate --values 1e-4,5e-4,1e-3 \\
      --sweep-dir results/sweep -- synthetic positional --num-steps 2000

  # Bayesian search over two dimensions, two runs at a time
  python -m fourier_feature_nets_torch.cli.sweep train_tiny_nerf \\
      --strategy bayesian --max-runs 12 --max-concurrent 2 \\
      --space "learning-rate=loguniform(1e-5,1e-2);num-channels=choice(64,128,256)" \\
      --sweep-dir results/sweep -- synthetic positional --num-steps 2000
"""

import os
import subprocess
import sys
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

from ..utils.search import BayesianSearch, parse_space

# the directory that holds the port's package, for the trainers' imports
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TRAINERS = ["train_signal_regression", "train_image_regression",
            "train_voxels", "train_tiny_nerf", "train_nerf"]


def _parse_args(argv=None):
    parser = ArgumentParser(
        "Hyperparameter Sweep",
        formatter_class=ArgumentDefaultsHelpFormatter)
    parser.add_argument("trainer", choices=TRAINERS)
    parser.add_argument("--strategy", default="grid",
                        choices=["grid", "random", "bayesian"])
    parser.add_argument("--param",
                        help="grid: hyperparameter flag to sweep "
                             "(no --)")
    parser.add_argument("--values",
                        help="grid: comma-separated values to try")
    parser.add_argument("--space",
                        help="random/bayesian search space, e.g. "
                             "\"learning-rate=loguniform(1e-5,1e-2);"
                             "num-channels=choice(64,256)\"")
    parser.add_argument("--max-runs", type=int, default=12,
                        help="random/bayesian: total trials")
    parser.add_argument("--max-concurrent", type=int, default=1,
                        help="Trainer subprocesses in flight at once")
    parser.add_argument("--seed", type=int, default=0,
                        help="Search RNG seed")
    parser.add_argument("--sweep-dir", required=True)
    parser.add_argument("--metric", default="psnr_val",
                        choices=["psnr_val", "psnr_train", "val_loss",
                                 "train_loss"])
    parser.add_argument("trainer_args", nargs="*",
                        help="Arguments forwarded to the trainer "
                             "(results_dir is injected per run)")
    return parser.parse_args(argv)


def best_metric_from_log(path: str, metric: str = "psnr_val") -> float:
    """Parses a TSV run log and returns the best value of the named
    metric column (column located via the header row; psnr_* metrics
    are maximized, *_loss metrics return the negated minimum so that
    'bigger is better' holds uniformly)."""
    minimize = metric.endswith("loss")
    best = float("-inf")
    column = None
    with open(path) as file:
        for line in file:
            parts = line.strip().split("\t")
            if column is None:
                if metric in parts:
                    column = parts.index(metric)
                continue
            if len(parts) > column:
                try:
                    value = float(parts[column])
                except ValueError:
                    continue
                best = max(best, -value if minimize else value)
    if column is None:
        # e.g. --metric psnr_val against train_signal_regression's
        # step/train_loss/val_loss log: every run would score -inf
        print(f"WARNING: metric '{metric}' not found in {path} — "
              "check --metric against the trainer's log columns",
              file=sys.stderr)
    return best


def _format(value) -> str:
    if isinstance(value, float):
        return f"{value:.6g}"
    return str(value)


def _launch(trainer, run_dir, trainer_args, overrides, extra_env=None):
    """Runs one trainer subprocess; returns its best metric."""
    cmd = [sys.executable, "-m",
           f"fourier_feature_nets_torch.cli.{trainer}"]
    cmd.extend(trainer_args)
    cmd.append(run_dir)
    for name, value in overrides.items():
        cmd.extend([f"--{name}", _format(value)])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
    if extra_env:
        env.update(extra_env)
    print("sweep run:", " ".join(cmd))
    return subprocess.run(cmd, env=env).returncode


def _run_result(run_dir, returncode, metric):
    if returncode != 0:
        print(f"  {run_dir}: failed (exit {returncode})")
        return float("-inf")
    log_path = os.path.join(run_dir, "log.txt")
    if not os.path.exists(log_path):
        return float("-inf")
    return best_metric_from_log(log_path, metric)


def run_sweep(trainer: str, param: str, values, sweep_dir: str,
              trainer_args, metric: str = "psnr_val",
              max_concurrent: int = 1):
    """Grid sweep: one training process per value (concurrently when
    ``max_concurrent`` > 1); returns (best_value, results dict)."""
    os.makedirs(sweep_dir, exist_ok=True)
    results = {}

    def one(value):
        run_dir = os.path.join(sweep_dir,
                               f"{param.replace('-', '_')}_{value}")
        code = _launch(trainer, run_dir, trainer_args, {param: value})
        return value, _run_result(run_dir, code, metric)

    with ThreadPoolExecutor(max_workers=max(1, max_concurrent)) as pool:
        for value, score in pool.map(one, values):
            results[value] = score
            print(f"  {param}={value}: {metric}={score:.3f}")

    best = max(results, key=results.get)
    print(f"best {param}: {best} ({metric}={results[best]:.3f})")
    return best, results


def run_search(trainer: str, space_spec: str, sweep_dir: str,
               trainer_args, metric: str = "psnr_val",
               strategy: str = "bayesian", max_runs: int = 12,
               max_concurrent: int = 1, seed: int = 0):
    """Random/Bayesian search over a multi-dimensional space with up
    to ``max_concurrent`` trainers in flight. Returns
    (best_params, best_score, trials list)."""
    os.makedirs(sweep_dir, exist_ok=True)
    space = parse_space(space_spec)
    search = BayesianSearch(
        space, seed=seed,
        # random strategy = all draws quasi-random, never fit the GP
        num_initial=max_runs if strategy == "random" else 4)

    trials = []
    launched = 0
    futures = {}

    def one(index, params):
        run_dir = os.path.join(sweep_dir, f"trial_{index:03d}")
        code = _launch(trainer, run_dir, trainer_args, params)
        return _run_result(run_dir, code, metric)

    with ThreadPoolExecutor(max_workers=max(1, max_concurrent)) as pool:
        while launched < max_runs or futures:
            while launched < max_runs and len(futures) < max_concurrent:
                params = search.suggest()
                futures[pool.submit(one, launched, params)] = params
                launched += 1
            done, _ = wait(futures, return_when=FIRST_COMPLETED)
            for future in done:
                params = futures.pop(future)
                score = future.result()
                search.observe(params, score)
                trials.append((params, score))
                print(f"  trial {len(trials)}/{max_runs}: "
                      f"{params} -> {metric}={score:.3f}")

    best_params, best_score = search.best() or ({}, float("-inf"))
    print(f"best ({strategy}, {len(trials)} trials): {best_params} "
          f"({metric}={best_score:.3f})")
    return best_params, best_score, trials


def main(argv=None):
    args = _parse_args(argv)
    if args.strategy == "grid":
        if not (args.param and args.values):
            raise SystemExit("grid strategy needs --param and --values")
        run_sweep(args.trainer, args.param, args.values.split(","),
                  args.sweep_dir, args.trainer_args, args.metric,
                  args.max_concurrent)
    else:
        if not args.space:
            raise SystemExit(f"{args.strategy} strategy needs --space")
        run_search(args.trainer, args.space, args.sweep_dir,
                   args.trainer_args, args.metric, args.strategy,
                   args.max_runs, args.max_concurrent, args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
