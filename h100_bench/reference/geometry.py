"""Ray geometry, sample placement and compositing in plain float32.

* Pinhole rays: pixel (x, y) looks along ``R K^-1 [x, y, 1]``, from the
  camera's position; a rig's rays are cast by unprojecting the pixel
  grid through the inverse of ``K (4x4) @ inv(extrinsics)`` in NumPy
  f32, as the original project casts them.
* The render volume is an axis-aligned box; the slab method gives each
  ray's entry and exit, the entry clamped to at least 0.1; a ray that
  misses gets near 1 and far 2 and is invalid.
* The occupancy sampler probes P bin midpoints along [near, far] in a
  max-pooled table of the 0/1 grid, weights each bin by its length
  times (occupancy + empty weight), and places the samples at evenly
  spaced (or, with jitter u, at (k + u) / S) quantiles of that CDF,
  interpolating linearly within a bin. A ray is a hit when a probe lies
  in, or within 1e-4 cells of a face of, an occupied cell.
* Compositing: alpha = 1 - exp(-softplus(o) * delta) with the last
  delta 1e10, transmittance the exclusive product of
  min(1, 1 - alpha + 1e-10), color the weighted sum of sigmoid colors,
  the ray's alpha the sum of all weights but the last.
* :func:`uniform_keyed` is the counter-based generator the project
  keys its stratified jitter and its distillation draws with: a
  ``lowbias32`` hash of (key, step, salt, ray id, lane).
"""

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["FACE_DELTA", "uniform_keyed", "pixel_rays", "rig_rays",
           "rig_tables", "box_near_far", "density_grid", "Occupancy",
           "composite", "composite_density"]

FACE_DELTA = 1e-4
_MASK = 0xFFFFFFFF


def _mul32(x, c: int):
    low = x * (c & 0xFFFF)
    high = ((x * (c >> 16)) & 0xFFFF) << 16
    return (low + high) & _MASK


def _mix32(x):
    x = x & _MASK
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniform_keyed(key: int, step: int, ids: torch.Tensor, lanes: int,
                  salt: int) -> torch.Tensor:
    """(R, lanes) uniforms in [0, 1) with 24 random bits, keyed by
    (key, step, salt) and each row's integer id."""
    mixed = _mix32(_mix32(_mix32(key) ^ (step & _MASK)) ^ (salt & _MASK))
    row = _mix32(_mix32(ids.to(torch.int64)) ^ mixed)
    lane = torch.arange(lanes, dtype=torch.int64, device=ids.device)
    bits = _mix32(row[:, None] ^ _mix32(lane + 0x9E3779B9)[None, :])
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def pixel_rays(ray_m: torch.Tensor, position: torch.Tensor, width: int,
               offsets: torch.Tensor):
    """(starts, unit directions) of pixel ``offsets`` (row-major) of a
    camera with ``ray_m = R @ inv(K)``."""
    x = (offsets % width).float()
    y = torch.div(offsets, width, rounding_mode="floor").float()
    d = x[:, None] * ray_m[:, 0] + y[:, None] * ray_m[:, 1] + ray_m[:, 2]
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return position.expand(d.shape), d


def rig_rays(intrinsics: np.ndarray, extrinsics: np.ndarray, width: int,
             height: int):
    """(origins, directions) of every pixel of every camera, camera-major
    and row-major, as f32 NumPy arrays."""
    xs, ys = np.meshgrid(np.arange(width), np.arange(height))
    points = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)
    lifted = np.concatenate([points, np.ones((points.shape[0], 2),
                                             np.float32)], -1)
    origins, directions = [], []
    for intr, extr in zip(intrinsics, extrinsics):
        proj = np.eye(4, dtype=np.float32)
        proj[:3, :3] = np.asarray(intr, np.float32)[:3, :3]
        projection = proj @ np.linalg.inv(np.asarray(extr, np.float32))
        world = lifted @ np.linalg.inv(projection).T
        position = np.asarray(extr, np.float32)[:3, 3].reshape(1, 3)
        d = world[:, :3] - position
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        origins.append(np.broadcast_to(position, d.shape))
        directions.append(d)
    return (np.concatenate(origins).astype(np.float32),
            np.concatenate(directions).astype(np.float32))


def rig_tables(intrinsics: np.ndarray, extrinsics: np.ndarray, device):
    """(ray_m (C, 3, 3), positions (C, 3)) of a rig: ``R @ inv(K)`` in
    NumPy f32 and the camera centers, on ``device``."""
    ray_m = np.stack([np.asarray(e, np.float32)[:3, :3]
                      @ np.linalg.inv(np.asarray(k, np.float32))
                      for k, e in zip(intrinsics, extrinsics)])
    positions = np.stack([np.asarray(e, np.float32)[:3, 3]
                          for e in extrinsics])
    return (torch.from_numpy(ray_m.astype(np.float32)).to(device),
            torch.from_numpy(positions.astype(np.float32)).to(device))


def box_near_far(starts, dirs, lo: torch.Tensor, hi: torch.Tensor):
    """(near, far, valid) of rays against the box [lo, hi]."""
    t0 = (lo - starts) / dirs
    t1 = (hi - starts) / dirs
    degenerate = torch.any(torch.isnan(t0) | torch.isnan(t1), dim=-1)
    near = torch.nan_to_num(torch.minimum(t0, t1), nan=-torch.inf).amax(-1)
    far = torch.nan_to_num(torch.maximum(t0, t1), nan=torch.inf).amin(-1)
    valid = (near < far) & ~degenerate
    near = torch.where(valid, torch.clamp(near, min=0.1), 1.0)
    far = torch.where(valid, far, 2.0)
    return near, far, valid


def linspace_rows(start, stop, num: int) -> torch.Tensor:
    """(R,) bounds -> (R, num) evenly spaced values, endpoints included."""
    steps = torch.arange(num, dtype=torch.float32,
                         device=start.device) / (num - 1)
    return start[:, None] + steps * (stop - start)[:, None]


def density_grid(model, resolution: int, scale: float,
                 threshold: float) -> torch.Tensor:
    """The (R, R, R) 0/1 grid, indexed [z, y, x], of cell centers whose
    alpha over one cell, 1 - exp(-softplus(sigma) * cell), exceeds
    ``threshold``."""
    device = next(model.parameters()).device
    centers = ((torch.arange(resolution, device=device, dtype=torch.float64)
                + 0.5) / resolution * 2 - 1) * scale
    z, y, x = torch.meshgrid(centers, centers, centers, indexing="ij")
    points = torch.stack([x, y, z], -1).reshape(-1, 3).float()
    with torch.no_grad():
        sigma = F.softplus(model(points, torch.zeros_like(points))[:, 3])
    alpha = 1.0 - torch.exp(-sigma * (2.0 * scale / resolution))
    return (alpha > threshold).float().reshape(resolution, resolution,
                                               resolution)


class Occupancy:
    """Probe-guided sample placement over a 0/1 grid on [-scale,
    scale]^3, read through its ``probe_resolution`` max-pooled table."""

    def __init__(self, grid: torch.Tensor, scale: float, num_probes: int,
                 empty_weight: float, probe_resolution: int):
        side = min(probe_resolution, grid.shape[0])
        factor = grid.shape[0] // side
        side = grid.shape[0] // factor
        self.table = F.max_pool3d(grid[None, None], factor)[0, 0]
        self.side = side
        self.grid_resolution = grid.shape[0]
        self.scale = scale
        self.num_probes = num_probes
        self.empty_weight = empty_weight

    def _cells(self, points: torch.Tensor) -> torch.Tensor:
        return (points / self.scale + 1.0) * 0.5 * self.side

    def _read(self, cell: torch.Tensor) -> torch.Tensor:
        x, y, z = torch.clamp(cell, 0, self.side - 1).unbind(-1)
        return self.table[z, y, x]

    def _probes(self, starts, dirs, near, far):
        edges = linspace_rows(near, far, self.num_probes + 1)
        mids = 0.5 * (edges[:, :-1] + edges[:, 1:])
        return edges, starts[:, None, :] + mids[..., None] * dirs[:, None, :]

    def hit(self, starts, dirs, near, far) -> torch.Tensor:
        """(R,) whether any probe of a ray is in or near an occupied
        cell."""
        _, probes = self._probes(starts, dirs, near, far)
        cell = self._cells(probes)
        own = torch.floor(cell)
        frac = cell - own
        step = ((frac > 1.0 - FACE_DELTA).long()
                - (frac < FACE_DELTA).long())
        own = own.long()
        found = torch.zeros(cell.shape[:-1], dtype=torch.bool,
                            device=cell.device)
        for bits in range(8):
            mask = torch.tensor([(bits >> a) & 1 for a in range(3)],
                                device=cell.device)
            found |= self._read(own + step * mask) > 0
        return found.any(dim=-1)

    def t_values(self, starts, dirs, near, far, num_samples: int,
                 jitter=None) -> torch.Tensor:
        """(R, num_samples) depths at the CDF's quantiles."""
        edges, probes = self._probes(starts, dirs, near, far)
        occupancy = self._read(torch.floor(self._cells(probes)).long())
        weights = ((edges[:, 1:] - edges[:, :-1])
                   * (occupancy + self.empty_weight) + 1e-12)
        cdf = torch.cumsum(weights, dim=-1)
        cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf / cdf[:, -1:]],
                        dim=-1)
        if jitter is None:
            quantiles = torch.linspace(0.0, 1.0, num_samples,
                                       device=starts.device)
            quantiles = quantiles.expand(starts.shape[0], num_samples)
        else:
            strata = torch.arange(num_samples, device=starts.device)
            quantiles = (strata + jitter) / num_samples
        quantiles = quantiles.contiguous()
        above = torch.searchsorted(cdf.contiguous(), quantiles, right=True)
        below = torch.clamp(above - 1, min=0)
        above = torch.clamp(above, max=self.num_probes)
        c0, c1 = cdf.gather(1, below), cdf.gather(1, above)
        t0, t1 = edges.gather(1, below), edges.gather(1, above)
        span = torch.where(c1 - c0 < 1e-9, torch.ones_like(c0), c1 - c0)
        return t0 + (quantiles - c0) / span * (t1 - t0)


def _blend(sigma: torch.Tensor, t_values: torch.Tensor) -> torch.Tensor:
    deltas = torch.cat([t_values[:, 1:] - t_values[:, :-1],
                        torch.full_like(t_values[:, :1], 1e10)], dim=-1)
    alpha = 1.0 - torch.exp(-sigma * deltas)
    terms = torch.clamp(1.0 - alpha + 1e-10, max=1.0)
    trans = torch.cat([torch.ones_like(terms[:, :1]),
                       torch.cumprod(terms, dim=-1)[:, :-1]], dim=-1)
    return alpha * trans


def composite_density(rgba: torch.Tensor, t_values: torch.Tensor,
                      valid: torch.Tensor):
    """(R, S, 4) colors and densities -> ((R, 3) color, (R,) alpha);
    rays that miss the box get no weight."""
    weights = _blend(rgba[..., 3], t_values) * valid[:, None]
    return (torch.sum(weights[..., None] * rgba[..., :3], dim=-2),
            torch.sum(weights[:, :-1], dim=-1))


def composite(logits: torch.Tensor, t_values: torch.Tensor):
    """(R, S, 4) logits at (R, S) depths -> ((R, 3) color, (R,) alpha)."""
    weights = _blend(F.softplus(logits[..., 3]), t_values)
    color = torch.sum(weights[..., None] * torch.sigmoid(logits[..., :3]),
                      dim=-2)
    return color, torch.sum(weights[:, :-1], dim=-1)
