"""Model families, each found by its configurations' ``model`` key: the
module ``families/<model>.py``. A family gives

* ``leaf_specs(cfg)``: ``[(name, shape, bound)]`` of every parameter, in
  the order the program's module registers them; the seeded draw of a
  leaf is uniform in ``[-bound, bound]`` (``weights.py``);
* ``program(cfg, flat, device)``: the port's model, built through its
  public constructors, holding the seeded leaves ``flat``;
* ``reference(cfg, flat, device)``: the plain float32 model (TF32 off),
  importing nothing of the port, called as ``model(points, views,
  quant=None)`` -> (N, 4) logits; ``quant="fp8"`` is the family's
  control, the nearest precision below its configurations';
* ``counts``: ``forward_flops(cfg)`` and ``step_flops(cfg)``, the model
  operations of a point's forward and of a point trained (``mfu.*``),
  and ``forward_bounds(cfg, points)`` and ``step_bounds(cfg, points)``,
  the least seconds of each kernel the family runs on ``points`` points,
  keyed as the readers read them (``k1_bound_s``, ``k2_bound_s``);
* ``TINY``: the keys that cut a configuration to a CPU's size (the CPU
  tests lay it over every configuration of the family).
"""

import importlib

__all__ = ["family"]


def family(cfg: dict):
    """The family module of configuration ``cfg``."""
    return importlib.import_module(f"{__name__}.{cfg['model']}")
