"""Bayesian hyperparameter search.

A copy of ``fourier_feature_nets_tpu/utils/search.py``, which is NumPy
only (the port imports nothing of the JAX package): a Gaussian-process
surrogate (RBF kernel on the normalized space, Cholesky with adaptive
jitter) drives expected-improvement acquisition over random candidates;
categorical dimensions are one-hot embedded. For the same seed it makes
the JAX module's suggestions bit for bit.

Search-space grammar (HyperDrive's distributions):

    "learning-rate=loguniform(1e-5,1e-2);num-channels=choice(64,256)"

- ``uniform(lo, hi)``     — continuous
- ``loguniform(lo, hi)``  — continuous, log-scaled
- ``quniform(lo, hi)``    — integer-rounded uniform
- ``choice(a, b, ...)``   — categorical (numbers or strings)
"""

import math
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["SearchSpace", "BayesianSearch", "parse_space"]


class _Dimension:
    def __init__(self, name: str, kind: str, args: List):
        self.name = name
        self.kind = kind
        self.args = args
        if kind == "choice":
            self.size = len(args)
        elif kind in ("uniform", "loguniform", "quniform"):
            self.size = 1
            self.low, self.high = float(args[0]), float(args[1])
            if kind == "loguniform" and self.low <= 0:
                raise ValueError(f"{name}: loguniform needs low > 0")
        else:
            raise ValueError(f"unknown distribution {kind!r}")

    def sample(self, rng: np.random.Generator):
        """Uniform draw in the embedded [0, 1)^size space."""
        return rng.uniform(size=self.size)

    def to_value(self, unit: np.ndarray):
        """Embedded coordinates -> parameter value."""
        if self.kind == "choice":
            return self.args[int(np.argmax(unit))]
        u = float(unit[0])
        if self.kind == "loguniform":
            return math.exp(math.log(self.low)
                            + u * (math.log(self.high)
                                   - math.log(self.low)))
        value = self.low + u * (self.high - self.low)
        return int(round(value)) if self.kind == "quniform" else value

    def to_unit(self, value) -> np.ndarray:
        """Parameter value -> embedded coordinates."""
        if self.kind == "choice":
            unit = np.zeros(self.size)
            unit[self.args.index(value)] = 1.0
            return unit
        value = float(value)
        if self.kind == "loguniform":
            u = ((math.log(value) - math.log(self.low))
                 / (math.log(self.high) - math.log(self.low)))
        else:
            u = (value - self.low) / (self.high - self.low)
        return np.asarray([min(max(u, 0.0), 1.0)])


class SearchSpace:
    """Ordered set of named dimensions with a [0,1]^D embedding."""

    def __init__(self, dimensions: List[_Dimension]):
        self.dimensions = dimensions

    @property
    def names(self) -> List[str]:
        return [d.name for d in self.dimensions]

    def sample(self, rng: np.random.Generator) -> Dict:
        return self.decode(np.concatenate(
            [d.sample(rng) for d in self.dimensions]))

    def decode(self, point: np.ndarray) -> Dict:
        values, start = {}, 0
        for dim in self.dimensions:
            values[dim.name] = dim.to_value(point[start:start + dim.size])
            start += dim.size
        return values

    def encode(self, params: Dict) -> np.ndarray:
        return np.concatenate([d.to_unit(params[d.name])
                               for d in self.dimensions])


def parse_space(spec: str) -> SearchSpace:
    """Parses the textual search-space grammar (module docstring)."""
    dims = []
    for part in filter(None, (p.strip() for p in spec.split(";"))):
        match = re.fullmatch(r"([\w.-]+)\s*=\s*(\w+)\((.*)\)", part)
        if not match:
            raise ValueError(f"bad dimension spec {part!r}")
        name, kind, argstr = match.groups()
        args = []
        for raw in argstr.split(","):
            raw = raw.strip()
            try:
                args.append(int(raw))
            except ValueError:
                try:
                    args.append(float(raw))
                except ValueError:
                    args.append(raw)
        dims.append(_Dimension(name, kind, args))
    if not dims:
        raise ValueError("empty search space")
    return SearchSpace(dims)


class _GaussianProcess:
    """RBF-kernel GP regression with adaptive-jitter Cholesky."""

    def __init__(self, length_scale: float = 0.2,
                 signal: float = 1.0, noise: float = 1e-4):
        self.length_scale = length_scale
        self.signal = signal
        self.noise = noise

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        sq = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return self.signal * np.exp(-0.5 * sq / self.length_scale ** 2)

    def fit(self, x: np.ndarray, y: np.ndarray):
        self.x = np.asarray(x, float)
        self.y_mean = float(np.mean(y))
        self.y_std = float(np.std(y)) or 1.0
        y = (np.asarray(y, float) - self.y_mean) / self.y_std
        k = self._kernel(self.x, self.x)
        jitter = self.noise
        for _ in range(8):
            try:
                self.chol = np.linalg.cholesky(
                    k + jitter * np.eye(len(k)))
                break
            except np.linalg.LinAlgError:
                jitter *= 10
        self.alpha = np.linalg.solve(
            self.chol.T, np.linalg.solve(self.chol, y))
        return self

    def predict(self, xq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        ks = self._kernel(np.asarray(xq, float), self.x)
        mu = ks @ self.alpha
        v = np.linalg.solve(self.chol, ks.T)
        var = np.maximum(self.signal - (v ** 2).sum(0), 1e-12)
        return (mu * self.y_std + self.y_mean,
                np.sqrt(var) * self.y_std)


def _expected_improvement(mu: np.ndarray, sigma: np.ndarray,
                          best: float) -> np.ndarray:
    """EI for maximization, standard closed form."""
    from math import erf
    z = (mu - best) / sigma
    cdf = 0.5 * (1.0 + np.vectorize(erf)(z / math.sqrt(2.0)))
    pdf = np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    return (mu - best) * cdf + sigma * pdf


class BayesianSearch:
    """Sequential (or batched, via pending-point hallucination)
    Bayesian maximizer over a :class:`SearchSpace`.

    ``suggest()`` returns the next configuration; ``observe()`` feeds
    a completed result back. Suggestions before ``num_initial``
    observations are quasi-random; afterwards a GP + expected
    improvement picks among random candidates. Pending (suggested but
    unobserved) points are hallucinated at the GP posterior mean — the
    "constant liar" strategy that keeps concurrent suggestions apart.
    """

    def __init__(self, space: SearchSpace, seed: int = 0,
                 num_initial: int = 4, num_candidates: int = 512):
        self.space = space
        self.rng = np.random.default_rng(seed)
        self.num_initial = num_initial
        self.num_candidates = num_candidates
        self.observed_x: List[np.ndarray] = []
        self.observed_y: List[float] = []
        self.pending: List[np.ndarray] = []

    def suggest(self) -> Dict:
        if (len(self.observed_x) < self.num_initial
                or len(self.observed_y) == 0):
            params = self.space.sample(self.rng)
            self.pending.append(self.space.encode(params))
            return params

        x = list(self.observed_x)
        y = list(self.observed_y)
        if self.pending:
            # constant liar: pretend pending runs return the mean
            lie = float(np.mean(y))
            x = x + self.pending
            y = y + [lie] * len(self.pending)
        gp = _GaussianProcess().fit(np.stack(x), np.asarray(y))

        candidates = np.stack([
            self.space.encode(self.space.sample(self.rng))
            for _ in range(self.num_candidates)])
        mu, sigma = gp.predict(candidates)
        ei = _expected_improvement(mu, sigma, max(self.observed_y))
        best = candidates[int(np.argmax(ei))]
        params = self.space.decode(best)
        # pend the NORMALIZED embedding (encode of the decoded value):
        # quniform rounds in decode, so the raw candidate coordinate
        # would never match observe()'s re-encoding and the liar entry
        # would haunt the surrogate forever
        self.pending.append(self.space.encode(params))
        return params

    def observe(self, params: Dict, value: float):
        point = self.space.encode(params)
        # drop at most ONE pending entry: two workers can hold
        # identical suggestions and only one of them finished
        for index, p in enumerate(self.pending):
            if np.allclose(p, point):
                del self.pending[index]
                break
        if math.isfinite(value):
            self.observed_x.append(point)
            self.observed_y.append(float(value))

    def best(self) -> Optional[Tuple[Dict, float]]:
        if not self.observed_y:
            return None
        index = int(np.argmax(self.observed_y))
        return (self.space.decode(self.observed_x[index]),
                self.observed_y[index])
