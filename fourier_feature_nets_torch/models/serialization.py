"""Self-describing NPZ checkpoints, interchangeable with the JAX package.

Port of ``save_model``/``load_model`` from
``fourier_feature_nets_tpu/models/serialization.py`` for the ``nerf``
type. The file holds a JSON ``__manifest__`` (``type`` + constructor
``params``) and the flattened parameter tree under keys such as
``layers/0/weight``, with weights stored (in, out) as the JAX package
keeps them. A checkpoint written by either package loads into the
other.
"""

import json
import os
from typing import Dict

import numpy as np
import torch

from .nerf import NeRF

__all__ = ["save_model", "load_model", "named_parameters", "params_from_jax",
           "params_to_jax"]

_HEADS = ("opacity_out", "bottleneck", "hidden_view", "color_out")
_TRAIN_STATE_FORMAT = "ffn_tpu_train_state_v1"


def _named_linears(model: NeRF):
    for i, layer in enumerate(model.layers):
        yield f"layers/{i}", layer
    for head in _HEADS:
        yield head, getattr(model, head)


def named_parameters(model: NeRF) -> Dict[str, torch.nn.Parameter]:
    """The model's parameters under the JAX package's flat paths
    (``layers/0/weight``, ...), in the module's own (out, in) layout."""
    return {f"{name}/{field}": getattr(layer, field)
            for name, layer in _named_linears(model)
            for field in ("weight", "bias")}


def params_to_jax(model: NeRF) -> Dict[str, np.ndarray]:
    """The model's parameters as the JAX package's flat
    ``{path: array}`` dict, weights transposed to (in, out)."""
    flat = {}
    for name, layer in _named_linears(model):
        flat[f"{name}/weight"] = layer.weight.detach().cpu().numpy().T.copy()
        flat[f"{name}/bias"] = layer.bias.detach().cpu().numpy().copy()
    return flat


def params_from_jax(model: NeRF, flat_params: Dict[str, np.ndarray]) -> NeRF:
    """Copies JAX-layout parameters into ``model`` in place.

    ``flat_params`` maps ``layers/0/weight``-style paths to arrays with
    weights stored (in, out) (the JAX package's x @ W convention); they
    are transposed to torch's (out, in). Every key must match a layer
    of the model with the right shape.
    """
    expected = set()
    with torch.no_grad():
        for name, layer in _named_linears(model):
            for field in ("weight", "bias"):
                key = f"{name}/{field}"
                expected.add(key)
                if key not in flat_params:
                    raise KeyError(f"checkpoint has no {key!r}")
                value = torch.tensor(np.asarray(flat_params[key],
                                                np.float32))
                if field == "weight":
                    value = value.T
                target = getattr(layer, field)
                if tuple(value.shape) != tuple(target.shape):
                    raise ValueError(
                        f"{key}: shape {tuple(value.shape)} does not match "
                        f"the model's {tuple(target.shape)}")
                target.copy_(value)
    extra = set(flat_params) - expected
    if extra:
        raise KeyError(f"checkpoint keys the model does not have: "
                       f"{sorted(extra)}")
    return model


def save_model(model: NeRF, path: str) -> None:
    """Saves a model to a self-describing NPZ checkpoint at exactly
    ``path`` (an open handle stops NumPy appending ``.npz``)."""
    manifest = {"type": model.model_type, "params": model.params_manifest}
    with open(path, "wb") as handle:
        np.savez(handle, __manifest__=json.dumps(manifest),
                 **params_to_jax(model))


def load_model(path: str) -> NeRF:
    """Loads a NeRF from an NPZ checkpoint written by either package
    (plain weights, or the JAX package's resumable train state, whose
    weights sit under ``params/``). Returns the model on the CPU."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with np.load(path, allow_pickle=False) as data:
        manifest = json.loads(str(data["__manifest__"]))
        flat = {k: data[k] for k in data.files if k != "__manifest__"}
    if manifest["type"] != "nerf":
        raise NotImplementedError(
            f"model type {manifest['type']!r} is not ported yet; the "
            "PyTorch port loads only 'nerf' checkpoints (see ROADMAP.md, "
            "queue 1, 'Remaining models, data, CLIs and parallel')")
    if manifest.get("format") == _TRAIN_STATE_FORMAT:
        flat = {k[len("params/"):]: v for k, v in flat.items()
                if k.startswith("params/")}
    model = NeRF(**manifest["params"])
    return params_from_jax(model, flat)
