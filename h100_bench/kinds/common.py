"""What the kinds of cell share: the device's clock, the kernels' bounds
summed, the checks' arithmetic."""

import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["Check", "compute_dtype", "add_bounds", "sync", "now", "pick",
           "leaf_gap", "leaf_diff", "moving_leaves", "frame_gaps", "worst",
           "WindowClosed"]


class Check(NamedTuple):
    """One number compared with the reference, with its limit."""

    name: str
    value: float
    limit: float

    @property
    def passed(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


class WindowClosed(Exception):
    """Raised from a callback of the program's own loop when the measured
    window has closed."""


def compute_dtype(cfg: dict) -> Optional[torch.dtype]:
    """The configuration's stated matmul type (None for full f32)."""
    return torch.bfloat16 if cfg["compute_dtype"] == "bfloat16" else None


def add_bounds(total: dict, bounds: dict) -> dict:
    """Adds a family's kernel bounds (``forward_bounds``, ``step_bounds``)
    into ``total``, key by key; returns ``total``."""
    for key, seconds in bounds.items():
        total[key] = total.get(key, 0.0) + seconds
    return total


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def now() -> float:
    return time.perf_counter()


def pick(seed: int, population, count: int) -> list:
    """``count`` members of ``population`` drawn from ``seed``."""
    population = sorted(population)
    rng = np.random.default_rng(seed)
    chosen = rng.choice(len(population), size=min(count, len(population)),
                        replace=False)
    return [population[i] for i in sorted(chosen)]


def leaf_gap(program: List[torch.Tensor], reference: List[torch.Tensor],
             keep: Optional[List[bool]] = None) -> float:
    """The worst leaf's gap between the two sides' norms, over the larger
    of the reference leaf's norm and the median leaf's."""
    ref_norms = [float(torch.linalg.norm(r.float())) for r in reference]
    floor = float(np.median(ref_norms))
    gaps = [abs(float(torch.linalg.norm(p.float())) - r) / max(r, floor, 1e-30)
            for p, r in zip(program, ref_norms)]
    if keep is not None:
        gaps = [g for g, k in zip(gaps, keep) if k]
    return max(gaps) if gaps else float("nan")


def leaf_diff(program: List[torch.Tensor],
              reference: List[torch.Tensor]) -> float:
    """The worst leaf's norm of the two sides' difference, over the larger
    of the reference leaf's norm and the median leaf's."""
    ref_norms = [float(torch.linalg.norm(r.float())) for r in reference]
    floor = float(np.median(ref_norms))
    return max(float(torch.linalg.norm(p.float() - r.float()))
               / max(n, floor, 1e-30)
               for p, r, n in zip(program, reference, ref_norms))


def call_summary(times: List[float]) -> str:
    """Median and extremes of a window's call times, in milliseconds."""
    if not times:
        return "no calls"
    ms = np.asarray(times) * 1e3
    return (f"{ms.size} calls, median {np.median(ms):.3f} ms, min "
            f"{ms.min():.3f}, max {ms.max():.3f}")


def moving_leaves(first_grads: List[torch.Tensor]) -> List[bool]:
    """The leaves whose first gradient in the reference is at least a
    thousandth of the median leaf's: the others move under Adam by
    round-off alone."""
    norms = [float(torch.linalg.norm(g)) for g in first_grads]
    floor = 1e-3 * float(np.median(norms))
    return [n >= floor for n in norms]


def frame_gaps(program: np.ndarray, reference: np.ndarray,
               drawn: np.ndarray) -> dict:
    """The mean absolute difference of two (H, W, 3) uint8 frames, in
    levels: over every pixel (``frame_mean_abs``), and over the pixels
    that the reference draws (the (H, W) mask ``drawn``) or where the two
    differ, so that what the program draws outside the reference's
    pixels counts too (``frame_mean_abs_drawn``; 0 where that set is
    empty). The second reads alike whatever share of the frame is
    drawn."""
    gap = np.abs(program.astype(np.int16) - reference.astype(np.int16))
    pixels = drawn | np.any(gap > 0, axis=-1)
    return {"frame_mean_abs": float(np.mean(gap)),
            "frame_mean_abs_drawn": (float(np.mean(gap[pixels]))
                                     if pixels.any() else 0.0)}


def worst(rows) -> dict:
    """The largest value of each name over ``rows`` (dicts of numbers)."""
    out = {}
    for row in rows:
        for name, value in row.items():
            out[name] = max(out.get(name, value), value)
    return out
