"""Experiment utilities: seeding, console logging, NaN debugging, gradient
telemetry and the multipitch evaluator.

The port's own copy of ``timbre_trap_tpu/utils/experiments.py``: the
evaluator accumulates per-track results of the port's metric suite
(``eval/multipitch.py``), adds the harmonic-mean ``f1-score`` and prefixes
keys with ``mpe/``. The gradient helpers take the port's gradient form, a
mapping from parameter name to tensor (``{n: p.grad for n, p in
net.named_parameters()}``), or nested dicts of tensors or arrays as the
JAX package does.
"""

import random
import sys
from copy import deepcopy

import numpy as np
import torch

from ..eval import multipitch as mp_metrics

__all__ = ["seed_everything", "print_and_log", "enable_nan_debugging",
           "sum_gradient_norms", "average_gradient_norms", "get_max_gradient",
           "get_max_gradient_norm", "log_gradient_norms",
           "MultipitchEvaluator"]


def enable_nan_debugging(enabled=True):
    """Switch autograd's anomaly detection, the reference's own NaN switch
    (``torch.autograd.set_detect_anomaly(True)``, train.py:362): a backward
    that produces NaN raises and names the forward operation at fault.
    Returns the previous setting."""
    previous = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(bool(enabled))
    return previous


def seed_everything(seed):
    """Seed Python's, numpy's and torch's global generators (every device),
    and return a ``torch.Generator`` seeded with ``seed`` for code that
    takes its randomness explicitly."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def print_and_log(text, path=None):
    """Print to console and optionally append to a log file."""
    print(text)
    if path is not None:
        with open(path, "a") as f:
            print(text, file=f)


def _leaves(grads, prefix=()):
    """(name, tensor) per gradient leaf: nested keys and the dotted parts of
    a parameter name joined with ``/``; None leaves (parameters without a
    gradient) are skipped."""
    for key, value in grads.items():
        path = prefix + tuple(str(key).split("."))
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _leaves(value, path)
        elif value is not None:
            yield "/".join(path), torch.as_tensor(
                value.detach() if isinstance(value, torch.Tensor)
                else np.asarray(value))


def _leaf_norms(grads):
    """(name, L2 norm) per leaf, reduced in float64 where the leaf lies."""
    return [(name, float(torch.linalg.vector_norm(leaf, dtype=torch.float64)))
            for name, leaf in _leaves(grads)]


def sum_gradient_norms(grads):
    """Cumulative L2 gradient norm across all parameter leaves
    (reference utils/experiments.py:144-169)."""
    return float(sum(n for _, n in _leaf_norms(grads)))


def average_gradient_norms(grads):
    """Average per-leaf L2 gradient norm (reference :172-202)."""
    norms = [n for _, n in _leaf_norms(grads)]
    return float(sum(norms) / max(len(norms), 1))


def get_max_gradient(grads):
    """Maximum absolute gradient entry over all leaves (reference :205-228)."""
    return float(max((float(leaf.abs().max()) for _, leaf in _leaves(grads)
                      if leaf.numel()), default=0.0))


def get_max_gradient_norm(grads):
    """Maximum per-leaf L2 gradient norm (reference :231-256)."""
    return float(max((n for _, n in _leaf_norms(grads)), default=0.0))


def log_gradient_norms(grads, writer, i=0, prefix="gradients/norm"):
    """Log every leaf's gradient norm to a TensorBoard-style ``writer``
    (reference :259-280) under ``<prefix>/<leaf name>``."""
    for name, norm in _leaf_norms(grads):
        writer.add_scalar(f"{prefix}/{name}", norm, i)


class MultipitchEvaluator:
    """Accumulate per-track MPE results and compute mean / std statistics."""

    def __init__(self, tolerance=0.5):
        self.tolerance = tolerance
        self.results = None
        self.reset_results()

    def reset_results(self):
        self.results = {}

    def append_results(self, results):
        for key, value in results.items():
            if key in self.results:
                self.results[key] = np.append(self.results[key], value)
            else:
                self.results[key] = np.array([value])

    def average_results(self):
        mean = deepcopy(self.results)
        std_dev = deepcopy(self.results)
        for key in self.results:
            mean[key] = round(float(np.mean(mean[key])), 5)
            std_dev[key] = round(float(np.std(std_dev[key])), 5)
        return mean, std_dev

    def evaluate(self, times_est, multi_pitch_est, times_ref, multi_pitch_ref):
        """Compute MPE results for one track's estimates vs ground truth."""
        results = mp_metrics.evaluate(times_ref, multi_pitch_ref,
                                      times_est, multi_pitch_est,
                                      window=self.tolerance)
        results = {k.lower(): results[k] for k in results.keys()}
        pr, rc = results["precision"], results["recall"]
        results["f1-score"] = 2 * pr * rc / (pr + rc + sys.float_info.epsilon)
        return {f"mpe/{k}": v for k, v in results.items()}
