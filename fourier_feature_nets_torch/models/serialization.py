"""Self-describing checkpoints, interchangeable with the JAX package.

Port of ``fourier_feature_nets_tpu/models/serialization.py`` for the
four model types (``fourier``, ``nerf``, ``voxels``,
``factorized_voxels``).

* NPZ (:func:`save_model`, :func:`load_model`): a JSON ``__manifest__``
  (``type`` + constructor ``params``) and the flattened parameter tree
  under the JAX package's keys (``layers/0/weight``, ``voxels``,
  ``bias``, ``plane_xy``, ``vector_z``, ``basis/weight``, ...) in its
  layouts: a Linear weight (in, out) where the module keeps (out, in), a
  grid (``voxels``, a plane) with its channels last where the module
  keeps (1, C, ...). :func:`~..utils.layout.to_jax_layout` and
  :func:`~..utils.layout.from_jax_layout` are that mapping, keyed by the
  path alone.
* The reference's ``.pt`` (:func:`save_torch_model`,
  :func:`load_torch_model`): ``type``, ``params`` and the module's own
  tensors (Linear weights (out, in), the voxel grid (1, 4, D, H, W) and
  bias (1, 4), the FFN's ``a_values``/``b_values`` and the NeRF's
  ``pos_encoding``/``view_encoding``). Factorized voxels have no
  reference format and raise, as in the JAX package.

A checkpoint written by either package loads into the other.
"""

import json
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..utils.layout import from_jax_layout, to_jax_layout
from .factorized import FactorizedVoxels
from .fourier import FourierFeatureMLP
from .nerf import NeRF
from .voxels import Voxels

__all__ = ["build_model", "from_jax_layout", "load_model",
           "load_torch_model", "named_parameters", "params_from_jax",
           "params_to_jax", "save_model", "save_torch_model",
           "to_jax_layout"]

_MODEL_TYPES = {
    "fourier": FourierFeatureMLP,
    "nerf": NeRF,
    "voxels": Voxels,
    "factorized_voxels": FactorizedVoxels,
}
_TRAIN_STATE_FORMAT = "ffn_tpu_train_state_v1"


def build_model(model_type: str, ctor_params: dict) -> nn.Module:
    """A model (on the CPU) from a checkpoint manifest's ``type`` and
    constructor ``params``."""
    if model_type not in _MODEL_TYPES:
        raise ValueError(f"Unrecognized model type: {model_type}")
    return _MODEL_TYPES[model_type](**ctor_params)


def named_parameters(model: nn.Module) -> Dict[str, nn.Parameter]:
    """The model's parameters under the JAX package's flat paths
    (``layers/0/weight``, ``voxels``, ...), in the module's own layout."""
    return {name.replace(".", "/"): param
            for name, param in model.named_parameters()}


def params_to_jax(model: nn.Module) -> Dict[str, np.ndarray]:
    """The model's parameters as the JAX package's flat
    ``{path: array}`` dict, in its layouts: host copies, which the
    model's later updates do not touch."""
    return {path: np.array(to_jax_layout(path, param.detach().cpu().numpy()),
                           order="C")
            for path, param in named_parameters(model).items()}


def params_from_jax(model: nn.Module,
                    flat_params: Dict[str, np.ndarray]) -> nn.Module:
    """Copies JAX-layout parameters into ``model`` in place.

    ``flat_params`` maps ``layers/0/weight``-style paths to arrays in
    the JAX package's layouts (:func:`from_jax_layout` maps them to the
    module's). Every key must match a parameter of the model with the
    right shape.
    """
    named = named_parameters(model)
    missing = set(named) - set(flat_params)
    if missing:
        raise KeyError(f"checkpoint has no {sorted(missing)[0]!r}")
    extra = set(flat_params) - set(named)
    if extra:
        raise KeyError(f"checkpoint keys the model does not have: "
                       f"{sorted(extra)}")
    with torch.no_grad():
        for path, target in named.items():
            value = torch.tensor(from_jax_layout(
                path, np.asarray(flat_params[path], np.float32)))
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(
                    f"{path}: shape {tuple(value.shape)} does not match "
                    f"the model's {tuple(target.shape)}")
            target.copy_(value)
    return model


def save_model(model: nn.Module, path: str) -> None:
    """Saves a model to a self-describing NPZ checkpoint at exactly
    ``path`` (an open handle stops NumPy appending ``.npz``)."""
    manifest = {"type": model.model_type, "params": model.params_manifest}
    with open(path, "wb") as handle:
        np.savez(handle, __manifest__=json.dumps(manifest),
                 **params_to_jax(model))


def load_model(path: str) -> nn.Module:
    """Loads a model of any of the four types from an NPZ checkpoint
    written by either package (plain weights, or the JAX package's
    resumable train state, whose weights sit under ``params/``), or
    from the reference's ``.pt`` / ``.pth`` (:func:`load_torch_model`).
    Returns the model on the CPU.

    A path that does not exist is looked up in the data cache's
    ``models/`` and, when its name is a known asset, downloaded there
    first (:func:`~..utils.assets.resolve_asset`); a file it cannot find
    or download raises ``FileNotFoundError``."""
    # imported here: the utils package imports this module
    from ..utils.assets import resolve_asset
    path = resolve_asset(path, "model", "models")
    if path.endswith((".pt", ".pth")):
        return load_torch_model(path)
    with np.load(path, allow_pickle=False) as data:
        manifest = json.loads(str(data["__manifest__"]))
        flat = {k: data[k] for k in data.files if k != "__manifest__"}
    if manifest.get("format") == _TRAIN_STATE_FORMAT:
        flat = {k[len("params/"):]: v for k, v in flat.items()
                if k.startswith("params/")}
    model = build_model(manifest["type"], manifest["params"])
    return params_from_jax(model, flat)


def _torch_tensors(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's tensors under the reference's ``.pt`` names."""
    if model.model_type == "factorized_voxels":
        raise ValueError(
            f"Model type {model.model_type!r} has no reference torch "
            "format (use save_model for the native NPZ checkpoint)")
    tensors = {name: value.detach().cpu().clone()
               for name, value in model.state_dict().items()}
    if model.model_type == "voxels":
        tensors["bias"] = tensors["bias"][None]   # (1, 4) in the reference
    return tensors


def save_torch_model(model: nn.Module, path: str) -> None:
    """Exports a model to the reference's PyTorch ``.pt`` format, which
    the reference's ``load_model`` and the JAX package's
    ``load_torch_model`` read."""
    torch.save({"type": model.model_type, "params": model.params_manifest,
                **_torch_tensors(model)}, path)


def load_torch_model(path: str) -> nn.Module:
    """Loads a reference-format ``.pt`` checkpoint (written by the
    reference, the JAX package or :func:`save_torch_model`) onto the
    CPU. Only tensors and plain containers are unpickled."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    model = build_model(state.pop("type"), state.pop("params"))
    expected = _torch_tensors(model)
    if set(state) != set(expected):
        raise KeyError(f"{path}: tensors {sorted(state)} do not match the "
                       f"model's {sorted(expected)}")
    with torch.no_grad():
        for name, target in model.state_dict().items():
            value = state[name].float()
            if name == "bias" and model.model_type == "voxels":
                value = value[0]
            if value.shape != target.shape:
                raise ValueError(f"{name}: shape {tuple(value.shape)} does "
                                 f"not match the model's "
                                 f"{tuple(target.shape)}")
            target.copy_(value)
    return model
