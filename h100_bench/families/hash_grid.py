"""The hash-grid family: Instant-NGP's NeRF, the port's
``models.hash_grid.HashGridNeRF`` (the encoding's kernels in
``kernels/csrc/hash_grid.cu``, its MLPs ``F.linear``), the plain
``reference.hash_grid.PlainHashGridNeRF`` and the frozen counts of
``counts/hash_grid.py``. The table is drawn from U(-1e-4, 1e-4) (the
paper, section 4), each MLP weight from U(-1/sqrt(fan_in),
1/sqrt(fan_in)); the MLPs have no biases."""

from ..counts import hash_grid as counts
from ..reference.hash_grid import PlainHashGridNeRF
from ..weights import assign

__all__ = ["TINY", "counts", "leaf_specs", "program", "reference"]

# a dense level and three hashed ones
TINY = {"n_levels": 4, "log2_hashmap_size": 8, "base_resolution": 4,
        "per_level_scale": 2.0, "density_neurons": 16, "color_neurons": 16}
TABLE_BOUND = 1e-4
# the model's constructor arguments, as the configuration names them
_ARGS = ("n_levels", "n_features_per_level", "log2_hashmap_size",
         "base_resolution", "per_level_scale", "density_neurons",
         "density_hidden_layers", "density_outputs", "color_neurons",
         "color_hidden_layers", "sh_degree", "scale")


def leaf_specs(cfg: dict):
    """[(name, shape, bound)]: the table (rows, 2), then every MLP weight
    (out, in), in the order the model registers them."""
    specs = [("table", (counts.table_rows(cfg), cfg["n_features_per_level"]),
              TABLE_BOUND)]
    for name, fan_in, fan_out in counts.layer_shapes(cfg):
        specs.append((f"{name}.weight", (fan_out, fan_in), fan_in ** -0.5))
    return specs


def program(cfg: dict, flat, device):
    """The program's HashGridNeRF of ``cfg`` on ``device`` holding
    ``flat``."""
    from fourier_feature_nets_torch.models import HashGridNeRF
    model = HashGridNeRF(**{key: cfg[key] for key in _ARGS}).to(device)
    assign(model, flat, leaf_specs(cfg))
    return model


def reference(cfg: dict, flat, device) -> PlainHashGridNeRF:
    model = PlainHashGridNeRF(cfg, device)
    assign(model, flat, leaf_specs(cfg))
    return model
