"""1-D signal regression dataset.

Port of ``fourier_feature_nets_tpu/datasets/signal_dataset.py``: the
samples of a signal over x in [0, 2) as tensors on an explicit device,
for a full-batch train step on the device. :meth:`SignalDataset.plot`
draws with matplotlib, imported when it is called; without matplotlib
(the card's machine has none) it raises ``ModuleNotFoundError`` naming
it, so a run there passes ``--no-plot``.
"""

from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = ["SignalData", "SignalDataset", "pyplot"]


class SignalData(NamedTuple):
    """x/y value pairs of a 1-D signal, each (N, 1)."""

    x: torch.Tensor
    y: torch.Tensor


def _get_limits(vals, stretch=1.1):
    vals = np.asarray(vals)
    min_v, max_v = float(vals.min()), float(vals.max())
    mid = 0.5 * (min_v + max_v)
    return mid + stretch * (min_v - mid), mid + stretch * (max_v - mid)


def pyplot():
    """matplotlib's ``pyplot`` on the Agg backend; raises
    ``ModuleNotFoundError`` naming matplotlib without it."""
    try:
        import matplotlib
    except ModuleNotFoundError as error:
        raise ModuleNotFoundError(
            "plotting a signal needs matplotlib, which is not installed; "
            "run without plots (--no-plot)", name="matplotlib") from error
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


class SignalDataset:
    """Dataset of 1-D signal samples over x in [0, 2)."""

    def __init__(self, train_data: SignalData, val_data: SignalData):
        self.train_x, self.train_y = train_data
        self.val_x, self.val_y = val_data
        self.x_lim = _get_limits(self.val_x.cpu())
        self.y_lim = _get_limits(self.val_y.cpu())

    @staticmethod
    def create(signal: Callable[[np.ndarray], np.ndarray],
               num_samples: int, sample_rate: int,
               device="cpu") -> "SignalDataset":
        """Train/val splits by dense sampling of ``signal``: val is the
        grid of ``num_samples * sample_rate`` points over [0, 2), train
        every ``sample_rate``-th of them; on ``device``."""
        x = np.linspace(0, 2, num_samples * sample_rate,
                        endpoint=False).astype(np.float32)
        y = signal(x).astype(np.float32)
        x = x.reshape(-1, 1)
        y = y.reshape(-1, 1)

        def tensor(array):
            return torch.from_numpy(np.ascontiguousarray(array)).to(device)

        train = SignalData(tensor(x[::sample_rate]), tensor(y[::sample_rate]))
        return SignalDataset(train, SignalData(tensor(x), tensor(y)))

    @torch.no_grad()
    def plot(self, space_ax, hidden_ax, model, num_points: int,
             colors: np.ndarray, max_hidden: int):
        """Plots the reconstruction and the ``max_hidden`` hidden units
        whose contributions vary most (the JAX package's drawing)."""
        plt = pyplot()
        val_x = self.val_x.cpu().numpy()
        x_vals = np.linspace(val_x[0, 0], val_x[-1, 0],
                             num_points).astype(np.float32)
        device = self.val_x.device
        y_vals, activation = model(
            torch.from_numpy(x_vals.reshape(-1, 1)).to(device),
            return_hidden=True)
        y_vals = y_vals.cpu().numpy().reshape(-1)
        activation = activation.cpu().numpy()

        out_layer = model.layers[-1]
        slope = out_layer.weight.detach().cpu().numpy().reshape(-1)
        bias = float(out_layer.bias.detach().cpu().numpy().reshape(-1)[0])

        activation_values = activation * slope[np.newaxis, :] + bias
        activation_range = (activation_values.max(0)
                            - activation_values.min(0))
        index = np.argsort(activation_range)[::-1][:max_hidden]
        cmap = plt.get_cmap("jet")
        for rank, i in enumerate(index):
            on_index = activation[:, i] > 0
            act_y = activation_values[:, i]
            hidden_ax.plot(x_vals, act_y, color=cmap(rank / max_hidden)[:3],
                           zorder=1, label="h{:02d}".format(i))
            hidden_ax.scatter(x_vals[on_index], act_y[on_index],
                              color=colors[on_index], marker=".", zorder=2)

        active = activation_values[activation > 0]
        if active.size:
            hidden_ax.set_ylim(*_get_limits(active))
        hidden_ax.legend(loc="upper right", ncol=2)
        space_ax.set_xlim(*self.x_lim)
        space_ax.set_ylim(*self.y_lim)
        space_ax.plot(val_x, self.val_y.cpu().numpy(), "r-", label="val",
                      zorder=1)
        space_ax.plot(self.train_x.cpu().numpy(),
                      self.train_y.cpu().numpy(), "go", label="train",
                      zorder=2)
        space_ax.scatter(x_vals, y_vals, color=colors, marker="P",
                         label="pred", zorder=3)
        space_ax.legend()
