"""Helpers of the port's tests for the occupancy probe's hit flag at cell
faces (``render/occupancy_sampler.py``, ``FACE_DELTA``)."""

import torch

from fourier_feature_nets_torch.render.occupancy_sampler import FACE_DELTA


class GatherHit:
    """An occupancy sampler whose probe's hit flag is the plain gather
    (each probe's own truncated cell): the flag before the repair, for
    a culled frame (``Raycaster.render_frame``)."""

    def __init__(self, sampler):
        self.sampler = sampler

    def __getattr__(self, name):
        return getattr(self.sampler, name)

    def _probe_cdf_geometry(self, starts, directions, near, far):
        edges, cdf, _ = self.sampler._probe_cdf_geometry(starts, directions,
                                                         near, far)
        return edges, cdf, gather_hit(self.sampler, starts, directions,
                                      near, far)


def gather_hit(sampler, starts, directions, near, far) -> torch.Tensor:
    """(R,) the hit flag of the plain gather: each probe's own truncated
    cell only, the flag the JAX package computes (on its own rounding)."""
    _, probes = sampler._probe_positions(starts, directions, near, far)
    return sampler._occupancy_at(probes).amax(-1) > 0


def face_bound(sampler, starts, directions, near, far) -> torch.Tensor:
    """(R,) rays with a probe within ``FACE_DELTA`` cells of a cell face
    on some axis: the rays whose flag may turn on f32 rounding."""
    _, probes = sampler._probe_positions(starts, directions, near, far)
    cell = sampler._cells(probes)
    near_face = (torch.floor(cell - FACE_DELTA)
                 != torch.floor(cell + FACE_DELTA)).any(-1)
    return near_face.reshape(probes.shape[:-2] + (-1,)).any(-1)
