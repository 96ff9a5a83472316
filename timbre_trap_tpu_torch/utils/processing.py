"""Array post-processing helpers.

The port's own numpy copy of ``timbre_trap_tpu/utils/processing.py``
(``to_array``, ``filter_non_peaks``, ``threshold``); the strict local-maximum
semantics match ``argrelmax`` with zero-padding rows.
"""

import numpy as np
import torch

__all__ = ["to_array", "filter_non_peaks", "threshold"]


def to_array(tensor):
    """Convert a torch tensor (on any device) or anything array-like to a
    numpy ndarray."""
    if isinstance(tensor, torch.Tensor):
        return tensor.detach().cpu().numpy()
    return np.asarray(tensor)


def filter_non_peaks(_arr):
    """Zero out values that are not strict local maxima along the vertical
    (second-to-last) axis; edge rows count as peaks vs an implicit zero row."""
    arr = np.asarray(_arr, dtype=np.float64)
    zeros = np.zeros(arr.shape[:-2] + (1,) + arr.shape[-1:])
    padded = np.concatenate([zeros, arr, zeros], axis=-2)
    above_prev = padded[..., 1:-1, :] > padded[..., :-2, :]
    above_next = padded[..., 1:-1, :] > padded[..., 2:, :]
    return np.where(above_prev & above_next, arr, 0.0)


def threshold(_arr, t=0.5):
    """Binarize data at threshold ``t`` (values >= t become 1)."""
    return (np.asarray(_arr) >= t).astype(np.float64)
