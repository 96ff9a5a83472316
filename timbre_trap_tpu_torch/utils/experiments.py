"""Experiment utilities: seeding, console logging and the multipitch
evaluator.

The port's own copy of ``seed_everything``, ``print_and_log`` and
``MultipitchEvaluator`` from ``timbre_trap_tpu/utils/experiments.py``: the
evaluator accumulates per-track results of the port's metric suite
(``eval/multipitch.py``), adds the harmonic-mean ``f1-score`` and prefixes
keys with ``mpe/``.
"""

import random
import sys
from copy import deepcopy

import numpy as np
import torch

from ..eval import multipitch as mp_metrics

__all__ = ["seed_everything", "print_and_log", "MultipitchEvaluator"]


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
