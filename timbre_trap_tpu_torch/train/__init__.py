"""Training: the Trainer, the step (loss, optax-equivalent AdamW, gradient
accumulation, telemetry), checkpoints, the recipe step's measurement, the
learning-rate schedules and seeded synthetic batches."""

from .checkpoint import (CHECKPOINT_FILE, latest_checkpoint, load_checkpoint, load_params,
                         save_checkpoint)
from .loop import Trainer, TrainerConfig
from .measure import reference_recipe_step_time
from .schedules import PlateauDecay, cosine_warmup
from .step import (TRAIN_AUDIO_SCALE, AdamW, MultiSteps, TrainConfig,
                   compact_audio, compact_ground_truth, grad_norm_telemetry,
                   init_train_state, make_loss_fn, make_optimizer,
                   make_train_step, shard_train_step,
                   step_gradients_reference)
from .synthetic import synthetic_batch

__all__ = ["AdamW", "CHECKPOINT_FILE", "MultiSteps", "PlateauDecay", "TRAIN_AUDIO_SCALE",
           "TrainConfig", "Trainer", "TrainerConfig", "compact_audio", "compact_ground_truth",
           "cosine_warmup", "grad_norm_telemetry", "init_train_state",
           "latest_checkpoint", "load_checkpoint", "load_params",
           "make_loss_fn", "make_optimizer", "make_train_step",
           "reference_recipe_step_time", "save_checkpoint",
           "shard_train_step",
           "step_gradients_reference", "synthetic_batch"]
