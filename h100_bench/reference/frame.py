"""A culled frame in plain float32: the hit set, the samples, the model
and the 8-bit image.

A frame's rays are the pixels of one camera. With probe stride s > 1
only every s-th pixel of each axis is probed (clamped to the image),
the coarse hit raster is dilated by its 3x3 neighbours and repeated back
to full size; a ray is drawn when its coarse neighbourhood hits and it
meets the box. The stride falls back to 1 when an occupied cell spans
fewer than 3 s pixels (focal length x cell / farthest camera distance).
Drawn rays are composited over their samples; every other pixel is
black. Colors are clamped to [0, 1], scaled by 255 and truncated.
"""

import torch
import torch.nn.functional as F

from .geometry import box_near_far, composite, pixel_rays

__all__ = ["effective_stride", "frame_hits", "render_frame"]

_BLOCK = 16384


def effective_stride(stride: int, grid_resolution: int, scale: float,
                     focal: float, distance: float) -> int:
    """The probe stride a frame uses (see the module's docstring)."""
    if stride <= 1:
        return stride
    span = focal * (2.0 * scale / grid_resolution) / max(distance, 1e-6)
    return stride if span >= 3.0 * stride else 1


def _hits(occupancy, ray_m, position, width, offsets, lo, hi):
    starts, dirs = pixel_rays(ray_m, position, width, offsets)
    near, far, valid = box_near_far(starts, dirs, lo, hi)
    return occupancy.hit(starts, dirs, near, far), valid


def frame_hits(occupancy, ray_m, position, width: int, height: int,
               stride: int, lo, hi) -> torch.Tensor:
    """(H * W,) bool: the rays a culled frame draws."""
    device = ray_m.device
    offsets = torch.arange(width * height, device=device)
    hits, valid = [], []
    for start in range(0, offsets.shape[0], _BLOCK * 4):
        h, v = _hits(occupancy, ray_m, position, width,
                     offsets[start:start + _BLOCK * 4], lo, hi)
        hits.append(h)
        valid.append(v)
    hit, valid = torch.cat(hits), torch.cat(valid)
    if stride > 1:
        rows = torch.clamp(torch.arange(-(-height // stride),
                                        device=device) * stride,
                           max=height - 1)
        cols = torch.clamp(torch.arange(-(-width // stride),
                                        device=device) * stride,
                           max=width - 1)
        coarse = (rows[:, None] * width + cols[None, :]).reshape(-1)
        coarse_hit, coarse_valid = _hits(occupancy, ray_m, position, width,
                                         coarse, lo, hi)
        raster = (coarse_hit & coarse_valid).float().reshape(
            1, 1, rows.shape[0], cols.shape[0])
        grown = F.max_pool2d(raster, 3, stride=1, padding=1)[0, 0] > 0
        hit = grown.repeat_interleave(stride, 0).repeat_interleave(
            stride, 1)[:height, :width].reshape(-1)
    return hit & valid


def render_frame(model, occupancy, ray_m, position, width: int,
                 height: int, num_samples: int, stride: int, lo, hi,
                 quant=None):
    """((H, W, 3) uint8 frame, (H, W) bool: the rays it draws) of one
    camera."""
    mask = frame_hits(occupancy, ray_m, position, width, height, stride,
                      lo, hi)
    drawn = torch.nonzero(mask).reshape(-1)
    colors = torch.zeros(width * height, 3, device=ray_m.device)
    with torch.no_grad():
        for start in range(0, drawn.shape[0], _BLOCK):
            offsets = drawn[start:start + _BLOCK]
            starts, dirs = pixel_rays(ray_m, position, width, offsets)
            near, far, _ = box_near_far(starts, dirs, lo, hi)
            t = occupancy.t_values(starts, dirs, near, far, num_samples)
            points = starts[:, None, :] + t[..., None] * dirs[:, None, :]
            views = dirs[:, None, :].expand(points.shape)
            logits = model(points.reshape(-1, 3), views.reshape(-1, 3),
                           quant=quant).reshape(offsets.shape[0],
                                                num_samples, 4)
            colors[offsets] = composite(logits, t)[0]
    image = torch.clamp(colors, 0.0, 1.0).reshape(height, width, 3)
    return (image * 255.0).to(torch.uint8), mask.reshape(height, width)
