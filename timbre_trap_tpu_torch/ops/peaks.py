"""Activation post-processing: peak picking and thresholding (kernel K2).

Counterpart of ``timbre_trap_tpu/ops/peaks.py`` and of the Pallas kernel
``ops/pallas_kernels.py:_kernel``. ``peak_mask`` runs the hand-written CUDA
kernel ``csrc/peak_mask.cu`` on a CUDA tensor and its plain twin
``peak_mask_reference`` on a CPU tensor. Both follow the XLA/numpy
definition ``threshold(filter_non_peaks(a), t)``: for ``t <= 0`` a non-peak
is marked 1.
"""

import torch

from ..utils.profiling import span
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
    the launches) and takes the plain twin for a CPU tensor; either way one
    ``tt.k2`` span.
    """
    with span("tt.k2"):
        a = torch.as_tensor(activations)
        if a.device.type == "cpu":
            return peak_mask_reference(a, t)
        if a.device.type != "cuda":
            raise ValueError(f"peak_mask runs on cuda or cpu, not {a.device}")
        if a.dtype != torch.float32:
            raise ValueError(f"peak_mask takes float32 activations, not "
                             f"{a.dtype}")
        if a.ndim < 2:
            raise ValueError("peak_mask needs (..., F, T) activations")
        out = torch.empty(a.shape, dtype=torch.uint8, device=a.device)
        if a.numel() == 0:
            return out
        f, t_len = a.shape[-2:]
        batch = a.numel() // (f * t_len)
        if batch > 65535:
            raise ValueError(f"peak_mask takes at most 65535 (F, T) planes, "
                             f"not {batch}")
        # The kernel reads (batch, F, T) planes and rows at any stride with
        # the frames contiguous (as transcribe's frame-trimmed output lies);
        # other layouts are copied first.
        v = (a.view(-1, f, t_len) if _planes_of_rows(a)
             else a.contiguous().view(-1, f, t_len))
        sb, sf = v.stride(0), v.stride(1)
        aligned = int(t_len % 4 == 0 and sb % 4 == 0 and sf % 4 == 0
                      and v.data_ptr() % 16 == 0)
        fn = _build.load("peak_mask", "tt_peak_mask")
        with torch.cuda.device(a.device):   # launch on the tensor's device
            rc = fn(v.data_ptr(), out.data_ptr(), batch, f, t_len, sb, sf,
                    float(t), aligned,
                    torch.cuda.current_stream(a.device).cuda_stream)
        _build.check(rc, "peak_mask")
        peak_mask.launches += 1
        return out


peak_mask.launches = 0


def _planes_of_rows(a):
    """Whether (..., F, T) ``a`` views as (B, F, T) with contiguous frames."""
    if a.stride(-1) != 1:
        return False
    try:
        a.view(-1, *a.shape[-2:])
    except RuntimeError:
        return False
    return True
