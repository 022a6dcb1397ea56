"""Seeded model weights, made on the device and handed to both sides.

Every leaf is uniform in ``[-bound, bound]``, its bound set by the
configuration's family (``families/<model>.py::leaf_specs``), drawn as
one flat f32 vector by a ``torch.Generator`` on the run's device in one
call. The program's model and the reference both take their leaves from
that vector by name, in the order of the family's ``leaf_specs``.
"""

import torch

from .families import family

__all__ = ["seeded_flat", "assign"]


def seeded_flat(cfg: dict, generator: torch.Generator,
                device) -> torch.Tensor:
    """One flat f32 vector of every parameter, drawn from ``generator``."""
    specs = family(cfg).leaf_specs(cfg)
    sizes = torch.tensor([int(torch.Size(shape).numel())
                          for _, shape, _ in specs], device=device)
    bounds = torch.tensor([bound for _, _, bound in specs], device=device)
    total = int(sizes.sum())
    uniform = torch.rand(total, generator=generator, device=device)
    return (2.0 * uniform - 1.0) * torch.repeat_interleave(bounds, sizes)


def assign(module: torch.nn.Module, flat: torch.Tensor, specs) -> None:
    """Copies ``flat`` into ``module``'s parameters by the names of
    ``specs`` (a family's ``leaf_specs``); raises when the module's
    parameters are not those, in that order."""
    params = dict(module.named_parameters())
    if list(params) != [name for name, _, _ in specs]:
        raise ValueError(f"the module's parameters {list(params)} are not "
                         f"the configuration's, in its order")
    offset = 0
    with torch.no_grad():
        for name, shape, _ in specs:
            size = int(torch.Size(shape).numel())
            params[name].copy_(flat[offset:offset + size].view(shape))
            offset += size
