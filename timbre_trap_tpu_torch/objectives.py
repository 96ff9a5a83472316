"""Training objectives as plain PyTorch functions.

The port's copy of ``timbre_trap_tpu/objectives.py`` (reference
``timbre_trap/framework/objectives.py``):

* reconstruction: elementwise MSE summed over channel+frequency, averaged
  over time+batch;
* transcription: MSE with optional per-frame positive-class imbalance
  weighting applied only where the target equals 1;
* consistency: two reconstruction losses of the re-encoded outputs against
  the transcription-coefficient target.

All functions take the reference layout ``(B, C, F, T)`` / ``(B, F, T)``.
"""

import torch

__all__ = ["compute_reconstruction_loss", "compute_transcription_loss",
           "compute_consistency_loss"]

_EPS = torch.finfo(torch.float32).eps


def compute_reconstruction_loss(reconstructed, target):
    """Sum squared error over channel/frequency, mean over time/batch."""
    se = torch.square(reconstructed - target)
    return torch.mean(torch.sum(se, dim=(-3, -2)))


def compute_transcription_loss(estimate, target, weight_positive_class=False):
    """MSE over (B, F, T) activations, summed over F, averaged over T/B.

    With ``weight_positive_class``, loss elements at target == 1 are scaled
    by the per-frame negative/positive count ratio.
    """
    loss = torch.square(estimate - target)
    if weight_positive_class:
        positive_weight = torch.sum(target, dim=-2, keepdim=True)
        negative_weight = torch.sum(1.0 - target, dim=-2, keepdim=True)
        positive_scaling = negative_weight / (positive_weight + _EPS)
        scaling = torch.where(target == 1, positive_scaling, 0.0)
        scaling = torch.where(scaling == 0, 1.0, scaling)
        loss = loss * scaling
    return torch.mean(torch.sum(loss, dim=-2))


def compute_consistency_loss(spectral_coefficients, transcription_coefficients,
                             target):
    """(spectral, transcription) consistency losses vs the coefficient target."""
    return (compute_reconstruction_loss(spectral_coefficients, target),
            compute_reconstruction_loss(transcription_coefficients, target))
