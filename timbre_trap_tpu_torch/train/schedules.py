"""Learning-rate schedules (the port's copy of
``timbre_trap_tpu/train/schedules.py``; pure host math).

* :func:`cosine_warmup` — the reference's "reverse cosine annealing" warmup
  (``timbre_trap/utils/experiments.py:81-141``): scaling rises from ~0 to 1
  over ``n_steps`` following ``1 - 0.5 * (1 + cos(step * pi / (n_steps+1)))``.
* :class:`PlateauDecay` — host-side ReduceLROnPlateau equivalent
  (``experiments/train.py:354-359``): halve the LR scale after ``patience``
  validation checkpoints without improvement, with a cooldown window.

The two compose multiplicatively: ``lr = base * warmup(step) * plateau.scale``.
"""

import math

import numpy as np

__all__ = ["cosine_warmup", "PlateauDecay"]


def cosine_warmup(n_steps):
    """Return schedule(step) -> scaling in [0, 1] (reverse cosine warmup),
    where ``step`` counts completed optimizer steps (the reference's
    ``last_epoch``)."""
    n_steps = max(0, int(n_steps))

    def schedule(step):
        if n_steps == 0:
            return np.float32(1.0)
        curr = 1 + min(float(np.asarray(step)), float(n_steps))
        return np.float32(
            1.0 - 0.5 * (1.0 + math.cos(curr * math.pi / (n_steps + 1))))

    return schedule


class PlateauDecay:
    """Halve an LR scale when a validation metric stops improving.

    Mirrors ``torch.optim.lr_scheduler.ReduceLROnPlateau`` as configured by
    the reference trainer: ``factor=0.5``, relative ``threshold=2e-3``,
    ``patience`` checkpoints, ``cooldown`` checkpoints after each decay.
    """

    def __init__(self, patience, cooldown=0, factor=0.5, threshold=2e-3,
                 maximize=True):
        self.patience = patience
        self.cooldown = cooldown
        self.factor = factor
        self.threshold = threshold
        self.maximize = maximize
        self.scale = 1.0
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0

    def _is_better(self, value):
        if self.best is None:
            return True
        if self.maximize:
            return value > self.best * (1.0 + self.threshold)
        return value < self.best * (1.0 - self.threshold)

    def step(self, value):
        """Record a validation metric; returns the (possibly decayed) scale."""
        if self._is_better(value):
            self.best = value
            self.num_bad = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.patience and self.num_bad > self.patience:
                self.scale *= self.factor
                self.cooldown_counter = self.cooldown
                self.num_bad = 0
        return self.scale
