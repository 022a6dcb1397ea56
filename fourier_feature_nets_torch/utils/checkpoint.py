"""Resumable train-state checkpoints, interchangeable with the JAX package.

Port of ``fourier_feature_nets_tpu/utils/checkpoint.py`` with the same
file format: one NPZ holding a JSON ``__manifest__`` (the model's
``type`` and constructor ``params``, the ``step``, the ``seed`` and
``"format": "ffn_tpu_train_state_v1"``), the weights under
``params/<path>``, the Adam moments under ``opt/mu/<path>`` and
``opt/nu/<path>`` and the Adam step count under ``opt/step``, every
matrix stored (in, out) as the JAX package keeps it. A checkpoint that
either package writes resumes in the other, and
:func:`~..models.serialization.load_model` reads its weights.

:class:`AsyncCheckpointer` snapshots the state with a device ``clone()``
(queued on the stream, nothing waits) and leaves the host copy and the
write to one background thread, with a latest-wins queue of depth 1.
"""

import json
import os
import threading
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..models.nerf import NeRF
from ..models.serialization import named_parameters, params_from_jax

__all__ = ["AdamState", "AsyncCheckpointer", "TrainState",
           "latest_checkpoint", "load_train_state", "save_train_state"]

FORMAT = "ffn_tpu_train_state_v1"


class AdamState(NamedTuple):
    """The JAX package's ``AdamState`` on the host: the update count and
    the moments as flat ``{path: array}`` dicts, (in, out)."""

    step: int
    mu: Dict[str, np.ndarray]
    nu: Dict[str, np.ndarray]


class TrainState(NamedTuple):
    """Everything needed to resume a training run."""

    model: NeRF
    params: Dict[str, np.ndarray]
    opt_state: AdamState
    step: int
    seed: int


def save_train_state(path: str, model: NeRF, params: Dict[str, np.ndarray],
                     opt_state: AdamState, step: int, seed: int = 0) -> None:
    """Writes a resumable checkpoint NPZ at exactly ``path``.

    Args:
        model: the model (its type and constructor parameters).
        params: its weights as
            :func:`~..models.serialization.params_to_jax` gives them.
        opt_state: the Adam state (``ClippedAdam.jax_state``).
        step: the last step trained; a resume starts at ``step + 1``.
        seed: the run's seed.
    """
    manifest = {
        "type": model.model_type,
        "params": model.params_manifest,
        "step": int(step),
        "seed": int(seed),
        "format": FORMAT,
    }
    flat = {f"params/{k}": np.asarray(v) for k, v in params.items()}
    flat.update({f"opt/mu/{k}": np.asarray(v)
                 for k, v in opt_state.mu.items()})
    flat.update({f"opt/nu/{k}": np.asarray(v)
                 for k, v in opt_state.nu.items()})
    flat["opt/step"] = np.asarray(opt_state.step, np.int32)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as handle:
        np.savez(handle, __manifest__=json.dumps(manifest), **flat)


def load_train_state(path: str) -> TrainState:
    """Loads a resumable checkpoint NPZ written by either package; the
    model is built on the CPU with the checkpoint's weights."""
    with np.load(path, allow_pickle=False) as data:
        manifest = json.loads(str(data["__manifest__"]))
        flat = {k: data[k] for k in data.files if k != "__manifest__"}
    fmt = manifest.get("format")
    if fmt != FORMAT:
        raise ValueError(
            f"{path} is not a resumable train-state checkpoint (manifest "
            f"format={fmt!r}); weights-only model files load via "
            "models.load_model")
    if manifest["type"] != "nerf":
        raise NotImplementedError(
            f"model type {manifest['type']!r} is not ported yet; the "
            "PyTorch port loads only 'nerf' checkpoints (see ROADMAP.md, "
            "queue 1, 'Remaining models, data, CLIs and parallel')")

    def part(prefix):
        return {k[len(prefix):]: v for k, v in flat.items()
                if k.startswith(prefix)}

    params = part("params/")
    model = params_from_jax(NeRF(**manifest["params"]), params)
    opt_state = AdamState(int(flat["opt/step"]), part("opt/mu/"),
                          part("opt/nu/"))
    return TrainState(model, params, opt_state, int(manifest["step"]),
                      int(manifest["seed"]))


def latest_checkpoint(directory: str,
                      prefix: str = "ckpt_") -> Optional[str]:
    """The newest ``{prefix}{step}.npz`` in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    best_step, best_path = -1, None
    for name in os.listdir(directory):
        if name.startswith(prefix) and name.endswith(".npz"):
            try:
                step = int(name[len(prefix):-4])
            except ValueError:
                continue
            if step > best_step:
                best_step, best_path = step, os.path.join(directory, name)
    return best_path


class AsyncCheckpointer:
    """Checkpoints that do not stall the step loop.

    :meth:`save` clones the weights and the Adam state on their device,
    which queues copies on the current stream and returns, and hands the
    clones to one background thread, which copies them to the host and
    writes ``{prefix}{step:08d}.npz``. The queue is depth 1, latest
    wins: if training outruns the writer, the intermediate checkpoints
    are skipped. The newest ``keep`` files are kept; older ones, as
    listed in the directory, are removed.
    """

    def __init__(self, directory: str, prefix: str = "ckpt_",
                 keep: int = 3):
        self.directory = directory
        self.prefix = prefix
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pending = None
        self._busy = False
        self._error = None
        self._closed = False
        self._cond = threading.Condition()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="ffn-torch-async-ckpt")
        self._thread.start()

    def save(self, model: NeRF, optimizer, step: int, seed: int = 0) -> None:
        """Snapshots ``model``'s weights and ``optimizer``'s
        (:class:`~.optim.ClippedAdam`) state on the device and enqueues
        the write of the checkpoint of ``step``."""
        named = named_parameters(model)
        optimizer.init_state()
        with torch.no_grad():
            snapshot = {
                path: (p.detach().clone(),
                       *(optimizer.optimizer.state[p][key].detach().clone()
                         for key in ("step", "exp_avg", "exp_avg_sq")))
                for path, p in named.items()}
        item = (model, snapshot, int(step), int(seed))
        with self._cond:
            if self._closed:
                raise RuntimeError("AsyncCheckpointer is closed")
            self._raise_pending_error()
            self._pending = item
            self._cond.notify_all()

    def wait(self) -> None:
        """Blocks until every enqueued checkpoint is on disk."""
        with self._cond:
            while self._pending is not None or self._busy:
                self._cond.wait()
            self._raise_pending_error()

    def close(self) -> None:
        """Flushes the pending write and stops the writer."""
        self.wait()
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()
        return False

    def _raise_pending_error(self):
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def _worker(self):
        while True:
            with self._cond:
                while self._pending is None and not self._closed:
                    self._cond.wait()
                if self._pending is None:
                    return
                item, self._pending = self._pending, None
                self._busy = True
            try:
                self._write(*item)
            except Exception as error:   # raised by the next save()/wait()
                self._error = error
            with self._cond:
                self._busy = False
                self._cond.notify_all()

    def _write(self, model, snapshot, step, seed):
        steps, params, mu, nu = set(), {}, {}, {}
        for path, (value, adam_step, exp_avg, exp_avg_sq) in snapshot.items():
            steps.add(int(adam_step.cpu()))
            for out, tensor in ((params, value), (mu, exp_avg),
                                (nu, exp_avg_sq)):
                array = tensor.cpu().numpy()
                out[path] = array.T.copy() if array.ndim == 2 else array
        path = os.path.join(self.directory, f"{self.prefix}{step:08d}.npz")
        save_train_state(path, model, params, AdamState(max(steps), mu, nu),
                         step, seed)
        self._prune()

    def _prune(self):
        suffix = ".npz"
        entries = []
        for name in os.listdir(self.directory):
            if name.startswith(self.prefix) and name.endswith(suffix):
                try:
                    entries.append(
                        (int(name[len(self.prefix):-len(suffix)]), name))
                except ValueError:
                    continue
        # remove the listed name: a checkpoint written by hand need not
        # be zero-padded
        for _, name in sorted(entries)[:-self.keep] if self.keep else []:
            os.unlink(os.path.join(self.directory, name))
