"""Plotting helpers (reference: timbre_trap/utils/visualization.py), the
port's copy of ``timbre_trap_tpu/utils/visualization.py``.

Magnitude heatmaps in [0, 1] and 2-D t-SNE scatter plots of latent codes
grouped by label. matplotlib (with the Agg backend where no display exists)
and scikit-learn are imported inside the functions, so the package imports
without either.
"""

import os

import numpy as np

from .processing import to_array

__all__ = ["initialize_figure", "plot_magnitude", "plot_latents"]


def _pyplot():
    import matplotlib

    if not hasattr(matplotlib, "_tt_tpu_backend_checked"):
        if not os.environ.get("DISPLAY"):
            matplotlib.use("Agg")
        matplotlib._tt_tpu_backend_checked = True
    import matplotlib.pyplot as plt

    return matplotlib, plt


def initialize_figure(figsize=(9, 3), interactive=False):
    """Create (and optionally show) a new figure."""
    matplotlib, plt = _pyplot()
    if interactive and not plt.isinteractive():
        plt.ion()
    fig = plt.figure(figsize=figsize, tight_layout=True)
    if not interactive and matplotlib.get_backend().lower() != "agg":
        plt.show(block=False)
    return fig


def plot_magnitude(magnitude, extent=None, colorbar=False, fig=None,
                   save_path=None):
    """Plot (F x T) magnitude coefficients in [0, 1] as a heatmap."""
    if fig is None:
        fig = initialize_figure(interactive=False)
    ax = fig.gca()
    if extent is not None:
        extent = [extent[0], extent[1], extent[3], extent[2]]
    img = ax.imshow(to_array(magnitude), vmin=0, vmax=1, extent=extent)
    ax.invert_yaxis()
    ax.set_aspect("auto")
    if extent is not None:
        ax.set_ylabel("Frequency (MIDI)")
        ax.set_xlabel("Time (s)")
    else:
        ax.axis("off")
    if colorbar:
        fig.colorbar(img)
    if save_path is not None:
        fig.savefig(save_path, bbox_inches="tight", pad_inches=0)
    return fig


def plot_latents(latents, labels, seed=0, fig=None, save_path=None):
    """t-SNE scatter (perplexity ``min(5, n - 1)``, ``random_state=seed``)
    of (L x D) latent codes colored by label."""
    from sklearn.manifold import TSNE

    if fig is None:
        fig = initialize_figure(figsize=(9, 6), interactive=False)
    ax = fig.gca()

    latents = to_array(latents)
    perplexity = min(5, max(1, len(latents) - 1))
    latents_2d = TSNE(n_components=2, perplexity=perplexity,
                      random_state=seed).fit_transform(latents)
    labels = np.array(labels)
    for label in np.unique(labels):
        idcs = labels == label
        ax.scatter(latents_2d[idcs, 0], latents_2d[idcs, 1], label=str(label))
    ax.legend()
    ax.set_xticks([])
    ax.set_yticks([])
    if save_path is not None:
        fig.savefig(save_path, bbox_inches="tight", pad_inches=0)
    return fig
