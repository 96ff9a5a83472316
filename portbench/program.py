"""The system under test, as the benchmark takes it: the only module here
that imports the port (``timbre_trap_tpu_torch``). It builds the port's
model from the harness's weights and hands back its public entry points;
nothing of the port reaches the reference.
"""

from timbre_trap_tpu_torch.models.timbre_trap import TimbreTrap
from timbre_trap_tpu_torch.ops.peaks import peak_mask

__all__ = ["build_model", "peak_mask", "make_step"]


def build_model(config, state_dict, device):
    """The port's model of ``config`` on ``device``, with the weights
    ``state_dict`` (reference names)."""
    m = config["model"]
    model = TimbreTrap(m["sample_rate"], m["n_octaves"], m["bins_per_octave"],
                       secs_per_block=m["secs_per_block"],
                       latent_size=m["latent_size"],
                       model_complexity=m["model_complexity"],
                       skip_connections=m["skip_connections"],
                       device=device)
    model.load_state_dict(state_dict)
    return model


def make_step(model, recipe):
    """The recipe's training step on ``model`` and its optimizer state:
    ``step(state, audio, ground_truth, lr) -> metrics`` (the Trainer's
    compact uploads: int16 audio on the ±8 grid, uint8 ground truth).
    The training package is imported here, not with this module: it
    brings the data package and SciPy, seconds of set-up that the
    inference cells do not need."""
    from timbre_trap_tpu_torch.train.step import (TrainConfig,
                                                  init_train_state,
                                                  make_train_step)

    cfg = TrainConfig(learning_rate=recipe["learning_rate"],
                      weight_decay=recipe["weight_decay"],
                      grad_clip=recipe["grad_clip"])
    step = make_train_step(model, cfg, mpe_batch_size=recipe["mpe_crops"],
                           conv_backend=recipe["conv_backend"],
                           compact_audio_grid=True)
    return step, init_train_state(model, cfg)
