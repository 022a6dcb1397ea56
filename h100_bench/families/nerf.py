"""The NeRF family: the port's ``models.nerf.NeRF`` (K1 runs its forward,
K2 its backward), the plain ``reference.model.PlainNeRF`` and the frozen
counts of ``counts/nerf.py``. Every weight and bias of a layer with
``fan_in`` inputs is drawn from U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
torch.nn.Linear's scheme."""

from ..counts import nerf as counts
from ..reference.model import PlainNeRF
from ..weights import assign

__all__ = ["TINY", "counts", "leaf_specs", "program", "reference"]

TINY = {"num_layers": 2, "num_channels": 32, "skips": [1],
        "num_freq_pos": 4, "max_log_scale_pos": 3.0,
        "num_freq_view": 2, "max_log_scale_view": 1.0}


def leaf_specs(cfg: dict):
    """[(name, shape, bound)] of every layer's weight (out, in) and bias,
    in the order the model registers them."""
    specs = []
    for name, fan_in, fan_out in counts.layer_shapes(cfg):
        bound = fan_in ** -0.5
        specs.append((f"{name}.weight", (fan_out, fan_in), bound))
        specs.append((f"{name}.bias", (fan_out,), bound))
    return specs


def program(cfg: dict, flat, device):
    """The program's NeRF of ``cfg`` on ``device`` holding ``flat``."""
    from fourier_feature_nets_torch.models.nerf import NeRF
    model = NeRF(cfg["num_layers"], cfg["num_channels"],
                 cfg["max_log_scale_pos"], cfg["num_freq_pos"],
                 cfg["max_log_scale_view"], cfg["num_freq_view"],
                 cfg["skips"], cfg["include_inputs"]).to(device)
    assign(model, flat, leaf_specs(cfg))
    return model


def reference(cfg: dict, flat, device) -> PlainNeRF:
    model = PlainNeRF(cfg, device)
    assign(model, flat, leaf_specs(cfg))
    return model
