"""Activation post-processing: peak picking and thresholding (kernel K2).

Counterpart of ``timbre_trap_tpu/ops/peaks.py`` and of the Pallas kernel
``ops/pallas_kernels.py:_kernel``. ``peak_mask`` runs the hand-written CUDA
kernel ``csrc/peak_mask.cu`` on a CUDA tensor and its plain twin
``peak_mask_reference`` on a CPU tensor. Both follow the XLA/numpy
definition ``threshold(filter_non_peaks(a), t)``: for ``t <= 0`` a non-peak
is marked 1.
"""

import torch

from . import _build

__all__ = ["filter_non_peaks", "threshold", "peak_mask", "peak_mask_reference"]


def filter_non_peaks(activations):
    """Zero non-peaks along the second-to-last (frequency) axis: a value is
    kept where it is strictly greater than both vertical neighbours (zero
    past the edges)."""
    a = torch.as_tensor(activations)
    p = torch.nn.functional.pad(a, (0, 0, 1, 1))
    above_prev = p[..., 1:-1, :] > p[..., :-2, :]
    above_next = p[..., 1:-1, :] > p[..., 2:, :]
    return torch.where(above_prev & above_next, a, torch.zeros_like(a))


def threshold(activations, t=0.5):
    """Binarize at ``t`` (values >= t become 1)."""
    return (torch.as_tensor(activations) >= t).to(torch.float32)


def peak_mask_reference(activations, t=0.5):
    """Plain PyTorch twin of ``peak_mask``."""
    return threshold(filter_non_peaks(activations), t).to(torch.uint8)


def peak_mask(activations, t=0.5):
    """(..., F, T) float32 activations -> uint8 peaks-then-threshold mask.

    Launches the CUDA kernel for a CUDA tensor (``peak_mask.launches`` counts
    the launches) and takes the plain twin for a CPU tensor.
    """
    a = torch.as_tensor(activations)
    if a.device.type == "cpu":
        return peak_mask_reference(a, t)
    if a.device.type != "cuda":
        raise ValueError(f"peak_mask runs on cuda or cpu, not {a.device}")
    if a.dtype != torch.float32:
        raise ValueError(f"peak_mask takes float32 activations, not {a.dtype}")
    if a.ndim < 2:
        raise ValueError("peak_mask needs (..., F, T) activations")
    a = a.contiguous()
    out = torch.empty(a.shape, dtype=torch.uint8, device=a.device)
    if a.numel() == 0:
        return out
    f, t_len = a.shape[-2:]
    fn = _build.load("peak_mask", "tt_peak_mask")
    rc = fn(a.data_ptr(), out.data_ptr(), a.numel() // (f * t_len), f, t_len,
            float(t), torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(rc, "peak_mask")
    peak_mask.launches += 1
    return out


peak_mask.launches = 0
