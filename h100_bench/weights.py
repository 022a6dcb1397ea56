"""Seeded model weights, made on the device and handed to both sides.

Every weight and bias of a layer with ``fan_in`` inputs is uniform in
``[-1/sqrt(fan_in), 1/sqrt(fan_in)]`` (torch.nn.Linear's scheme), drawn
as one flat f32 vector by a ``torch.Generator`` on the run's device in
two calls. The program's model and the reference both take their
leaves from that vector by name, in the order of ``layer_shapes``.
"""

import torch

from .counts.nerf import layer_shapes

__all__ = ["leaf_specs", "seeded_flat", "assign"]


def leaf_specs(cfg: dict):
    """[(name, shape, fan_in)] of every parameter, weights as (out, in)."""
    specs = []
    for name, fan_in, fan_out in layer_shapes(cfg):
        specs.append((f"{name}.weight", (fan_out, fan_in), fan_in))
        specs.append((f"{name}.bias", (fan_out,), fan_in))
    return specs


def seeded_flat(cfg: dict, generator: torch.Generator,
                device) -> torch.Tensor:
    """One flat f32 vector of every parameter, drawn from ``generator``."""
    specs = leaf_specs(cfg)
    sizes = torch.tensor([int(torch.Size(shape).numel())
                          for _, shape, _ in specs], device=device)
    bounds = torch.tensor([fan_in ** -0.5 for _, _, fan_in in specs],
                          device=device)
    total = int(sizes.sum())
    uniform = torch.rand(total, generator=generator, device=device)
    return (2.0 * uniform - 1.0) * torch.repeat_interleave(bounds, sizes)


def assign(module: torch.nn.Module, flat: torch.Tensor, cfg: dict) -> None:
    """Copies ``flat`` into ``module``'s parameters by name; raises when
    the module's parameters are not the configuration's."""
    params = dict(module.named_parameters())
    specs = leaf_specs(cfg)
    if sorted(params) != sorted(name for name, _, _ in specs):
        raise ValueError(f"the module's parameters {sorted(params)} are not "
                         f"the configuration's")
    offset = 0
    with torch.no_grad():
        for name, shape, _ in specs:
            size = int(torch.Size(shape).numel())
            params[name].copy_(flat[offset:offset + size].view(shape))
            offset += size
