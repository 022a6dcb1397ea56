"""What the kinds of cell share: the program's model built from the seeded
weights, the device's clock, the checks' arithmetic."""

import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..reference.model import PlainNeRF
from ..weights import assign

__all__ = ["Check", "compute_dtype", "program_nerf", "reference_nerf",
           "sync", "now", "pick", "leaf_gap", "leaf_diff", "moving_leaves",
           "mean_abs_gap", "WindowClosed"]


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


def program_nerf(cfg: dict, flat: torch.Tensor, device):
    """The program's NeRF of ``cfg`` on ``device`` with the seeded
    weights ``flat``."""
    from fourier_feature_nets_torch.models.nerf import NeRF
    model = NeRF(cfg["num_layers"], cfg["num_channels"],
                 cfg["max_log_scale_pos"], cfg["num_freq_pos"],
                 cfg["max_log_scale_view"], cfg["num_freq_view"],
                 cfg["skips"], cfg["include_inputs"]).to(device)
    assign(model, flat, cfg)
    return model


def reference_nerf(cfg: dict, flat: torch.Tensor, device) -> PlainNeRF:
    model = PlainNeRF(cfg, device)
    assign(model, flat, cfg)
    return model


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


def mean_abs_gap(program: np.ndarray, reference: np.ndarray) -> float:
    """The mean absolute difference of two uint8 frames, in levels."""
    return float(np.mean(np.abs(program.astype(np.int16)
                                - reference.astype(np.int16))))
