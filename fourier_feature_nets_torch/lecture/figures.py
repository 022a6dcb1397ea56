"""Lecture figures: why Fourier features work.

Port of ``fourier_feature_nets_tpu/lecture/figures.py``: matplotlib
figures of signal spectra, the spectral bias of plain MLPs against
Fourier-feature MLPs (trained with the port's models and optimizer),
the encoding matrices, and 1-D and 2-D Fourier decompositions. Each
raises ``ModuleNotFoundError`` naming matplotlib when it is missing.
The Gaussian encoding matrix is drawn from a ``torch.Generator``, so
its values are not the JAX package's for the same seed.
"""

import numpy as np
import torch

from ..ops.encoding import (
    gaussian_encoding_matrix,
    positional_encoding_matrix,
)

__all__ = ["signal_spectrum_figure", "encoding_matrix_figure",
           "spectral_bias_figure", "fourier1d_figure",
           "fourier2d_figure", "save_all_figures"]


def _agg_plt():
    """matplotlib's pyplot on the Agg backend; raises
    ``ModuleNotFoundError`` naming matplotlib without it."""
    try:
        import matplotlib
    except ModuleNotFoundError as error:
        raise ModuleNotFoundError(
            "the lecture figures and animations draw with matplotlib, "
            "which is not installed", name="matplotlib") from error
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def signal_spectrum_figure(signal_fn, num_samples=512, label="signal"):
    """Signal + magnitude spectrum side by side."""
    plt = _agg_plt()
    x = np.linspace(0, 2, num_samples, endpoint=False)
    y = signal_fn(x)
    spectrum = np.abs(np.fft.rfft(y)) / num_samples
    freqs = np.fft.rfftfreq(num_samples, d=2 / num_samples)

    fig, (ax0, ax1) = plt.subplots(1, 2, figsize=(10, 4))
    ax0.plot(x, y)
    ax0.set_title(label)
    ax0.set_xlabel("x")
    ax1.stem(freqs[:40], spectrum[:40])
    ax1.set_title("magnitude spectrum")
    ax1.set_xlabel("frequency")
    fig.tight_layout()
    return fig


def encoding_matrix_figure(max_log_scale=6.0, embedding_size=64,
                           sigma=10.0):
    """Positional vs Gaussian encoding matrices as heatmaps; the
    Gaussian one is drawn from a ``torch.Generator`` seeded 0."""
    plt = _agg_plt()
    pos_b = positional_encoding_matrix(max_log_scale,
                                       embedding_size // 2, 2)
    gauss_b = gaussian_encoding_matrix(torch.Generator().manual_seed(0),
                                       sigma, 2, embedding_size)

    fig, (ax0, ax1) = plt.subplots(1, 2, figsize=(10, 3))
    im0 = ax0.imshow(pos_b, aspect="auto", cmap="RdBu")
    ax0.set_title("positional (log-spaced axis-aligned)")
    fig.colorbar(im0, ax=ax0)
    im1 = ax1.imshow(gauss_b, aspect="auto", cmap="RdBu")
    ax1.set_title(f"gaussian (sigma={sigma})")
    fig.colorbar(im1, ax=ax1)
    fig.tight_layout()
    return fig


def spectral_bias_figure(num_steps=600, num_channels=64, device="cuda"):
    """Trains a plain MLP and two Fourier MLPs on a multi-frequency
    signal (full-batch Adam, lr 5e-4, weight decay 1e-3, on ``device``)
    and plots what each learns: the lecture's core point."""
    plt = _agg_plt()
    from ..cli.train_signal_regression import multifreq
    from ..datasets.signal_dataset import SignalDataset
    from ..models import MLP, BasicFourierMLP, FourierFeatureMLP
    from ..utils.optim import ClippedAdam

    dataset = SignalDataset.create(multifreq, 32, 8, device)

    def train(model):
        model = model.to(device)
        optimizer = ClippedAdam(model.parameters(), 5e-4, 1e-3,
                                clip_value=None, clip_norm=None)
        for _ in range(num_steps):
            optimizer.zero_grad()
            loss = torch.mean(torch.square(model(dataset.train_x)
                                           - dataset.train_y))
            loss.backward()
            optimizer.step(5e-4)
        with torch.no_grad():
            return model(dataset.val_x).cpu().numpy().reshape(-1)

    b = np.arange(1, 17, dtype=np.float32).reshape(1, -1)
    a = 1 / np.arange(1, 17, dtype=np.float32)

    def generator():
        return torch.Generator().manual_seed(0)

    models = {
        "plain MLP": MLP(1, 1, num_layers=1, num_channels=num_channels,
                         generator=generator()),
        "basic Fourier": BasicFourierMLP(1, 1, num_layers=1,
                                         num_channels=num_channels,
                                         generator=generator()),
        "Fourier series": FourierFeatureMLP(1, 1, a, b, [num_channels],
                                            generator=generator()),
    }

    fig, axes = plt.subplots(1, len(models), figsize=(13, 4),
                             sharey=True)
    x = dataset.val_x.cpu().numpy().reshape(-1)
    y = dataset.val_y.cpu().numpy().reshape(-1)
    for ax, (name, model) in zip(axes, models.items()):
        pred = train(model)
        ax.plot(x, y, "r-", label="target", linewidth=1)
        ax.plot(x, pred, "b-", label="learned", linewidth=1)
        ax.plot(dataset.train_x.cpu().numpy().reshape(-1),
                dataset.train_y.cpu().numpy().reshape(-1), "go",
                markersize=3, label="train")
        ax.set_title(name)
        ax.legend()
    fig.suptitle("Spectral bias: what each architecture can learn")
    fig.tight_layout()
    return fig


def fourier1d_figure(signal_fn=None, num_samples=64, num_freqs=4,
                     tsv_path=None):
    """Top Fourier basis functions + progressive reconstructions of a
    1-D signal, and optionally the table ``fourier_plots.tsv`` (t, f(t),
    basis_i..., recon_i...).

    Args:
        signal_fn: callable t -> y over [0, 2); defaults to the
            multifreq signal.
        num_samples: FFT size.
        num_freqs: how many dominant frequencies to plot/accumulate.
        tsv_path: where to write the table, when set.
    """
    plt = _agg_plt()
    if signal_fn is None:
        from ..cli.train_signal_regression import multifreq as signal_fn

    t = np.linspace(0, 2, num_samples)
    y = signal_fn(t)
    y_freq = np.fft.fft(y)
    order = np.argsort(np.abs(y_freq[:num_samples // 2]))[::-1]

    basis, recon = [], []
    subset_acc = np.zeros_like(y_freq)
    for i in range(num_freqs):
        f = order[i]
        single = np.zeros_like(y_freq)
        single[f] = y_freq[f]
        single[-f] = y_freq[-f]
        basis.append(np.fft.ifft(single).real)
        subset_acc[f] = y_freq[f]
        subset_acc[-f] = y_freq[-f]
        recon.append(np.fft.ifft(subset_acc).real)

    if tsv_path:
        with open(tsv_path, "w") as file:
            file.write("\t".join(
                ["t", "f(t)"]
                + [f"basis{i}" for i in range(num_freqs)]
                + [f"recon{i}" for i in range(num_freqs)]) + "\n")
            for k in range(num_samples):
                vals = [t[k], y[k]] + [b[k] for b in basis] \
                    + [r[k] for r in recon]
                file.write("\t".join(str(v) for v in vals) + "\n")

    fig, (ax0, ax1) = plt.subplots(1, 2, figsize=(11, 4))
    ax0.plot(t, y, "k-", linewidth=2, label="signal")
    for i, b in enumerate(basis):
        ax0.plot(t, b, "--", label=f"basis {i}")
    ax0.set_title("dominant Fourier basis functions")
    ax0.legend(fontsize=8)
    ax1.plot(t, y, "k-", linewidth=2, label="signal")
    for i, r in enumerate(recon):
        ax1.plot(t, r, "--", label=f"top-{i + 1} recon")
    ax1.set_title("progressive reconstruction")
    ax1.legend(fontsize=8)
    fig.tight_layout()
    return fig


def fourier2d_figure(image=None, size=64, num_gratings=3, device="cuda"):
    """2-D spectrum + individual sinusoidal gratings of an image.

    Args:
        image: (H, W) grayscale float array; defaults to a view of the
            synthetic scene rendered on ``device`` (no image files
            needed).
        size: image side when rendering the default image.
        num_gratings: dominant non-DC gratings to visualize.
    """
    plt = _agg_plt()
    if image is None:
        from ..cameras import Resolution
        from ..datasets.synthetic import (
            make_scene_volume,
            render_dataset_images,
        )
        from ..utils.camera_paths import orbit

        cams = orbit(np.array([0.0, 1.0, 0.0]),
                     np.array([0.0, 0.0, 1.0]), 2, 40.0,
                     Resolution(size, size), 3.0)
        bounds = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
        rgba = render_dataset_images(make_scene_volume(32), cams, bounds,
                                     num_samples=64, device=device)[0]
        image = (rgba[..., :3].astype(np.float32)
                 * (rgba[..., 3:] / 255.0)).mean(-1) / 255.0

    freq = np.fft.fftshift(np.fft.fft2(np.fft.ifftshift(image)))
    mag = np.abs(freq)
    center = np.array(mag.shape) // 2
    flat = mag.copy()
    flat[center[0], center[1]] = 0  # drop DC for grating selection
    order = np.argsort(flat.reshape(-1))[::-1]

    fig, axes = plt.subplots(1, 2 + num_gratings,
                             figsize=(3 * (2 + num_gratings), 3.2))
    axes[0].imshow(image, cmap="gray")
    axes[0].set_title("image")
    axes[1].imshow(np.log1p(mag), cmap="magma")
    axes[1].set_title("log spectrum")
    shown = 0
    used = set()
    for pos in order:
        if shown >= num_gratings:
            break
        r, c = divmod(int(pos), mag.shape[1])
        # conjugate pairs produce the same grating; show each once
        if (r, c) in used:
            continue
        used.add((r, c))
        used.add(((2 * center[0] - r) % mag.shape[0],
                  (2 * center[1] - c) % mag.shape[1]))
        single = np.zeros_like(freq)
        single[r, c] = freq[r, c]
        rr = (2 * center[0] - r) % mag.shape[0]
        cc = (2 * center[1] - c) % mag.shape[1]
        single[rr, cc] = freq[rr, cc]
        grating = np.fft.fftshift(
            np.fft.ifft2(np.fft.ifftshift(single))).real
        axes[2 + shown].imshow(grating, cmap="gray")
        axes[2 + shown].set_title(
            f"grating ({r - center[0]}, {c - center[1]})")
        shown += 1
    for ax in axes:
        ax.set_axis_off()
    fig.tight_layout()
    return fig


def save_all_figures(output_dir: str, device="cuda"):
    """Renders every lecture figure to PNG, training and rendering on
    ``device``."""
    import os

    from ..cli.train_signal_regression import multifreq, sawtooth

    os.makedirs(output_dir, exist_ok=True)
    figures = {
        "signal_multifreq.png": lambda: signal_spectrum_figure(
            multifreq, label="multifreq"),
        "signal_sawtooth.png": lambda: signal_spectrum_figure(
            sawtooth, label="sawtooth"),
        "encoding_matrices.png": encoding_matrix_figure,
        "spectral_bias.png": lambda: spectral_bias_figure(device=device),
        "fourier1d.png": lambda: fourier1d_figure(
            tsv_path=os.path.join(output_dir, "fourier_plots.tsv")),
        "fourier2d.png": lambda: fourier2d_figure(device=device),
    }
    for name, make in figures.items():
        fig = make()
        fig.savefig(os.path.join(output_dir, name), dpi=120)
        print("wrote", name)
