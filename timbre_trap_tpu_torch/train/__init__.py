"""Training: the step (loss, optax-equivalent AdamW, telemetry), the
learning-rate schedules and seeded synthetic batches."""

from .schedules import PlateauDecay, cosine_warmup
from .step import (TRAIN_AUDIO_SCALE, AdamW, TrainConfig, compact_audio,
                   compact_ground_truth, grad_norm_telemetry,
                   init_train_state, make_loss_fn, make_optimizer,
                   make_train_step)
from .synthetic import synthetic_batch

__all__ = ["AdamW", "PlateauDecay", "TRAIN_AUDIO_SCALE", "TrainConfig",
           "compact_audio", "compact_ground_truth",
           "cosine_warmup", "grad_norm_telemetry", "init_train_state",
           "make_loss_fn", "make_optimizer", "make_train_step",
           "synthetic_batch"]
