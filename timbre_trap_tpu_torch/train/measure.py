"""The reference-recipe train step's time, first loss and peak memory.

Counterpart of ``timbre_trap_tpu/train/measure.py`` for any family: one
definition of the step benchmark (batch 8 x 3-block crops, consistency
on — reference ``experiments/train.py:39-101``) for the tools that report
it. Each timed step ends in ``torch.cuda.synchronize()`` on the card.
"""

import time

import numpy as np
import torch

__all__ = ["reference_recipe_step_time"]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reference_recipe_step_time(model, conv_backend="pallas_bf16", batch=8,
                               blocks=3, iters=3, lr=1e-3, seed=0,
                               return_memory=False):
    """Time one training step of ``model`` (any family) on a seeded batch of
    ``batch`` crops of ``blocks`` sliCQ blocks, every crop annotated.

    Returns ``(step_seconds, first_loss)``: the least wall time over
    ``iters`` steps after a first one (each from the call to the
    synchronize that closes it) on the model's device, and the first
    step's total loss. ``return_memory=True`` appends the card's peak
    allocated bytes over all the steps (``torch.cuda.max_memory_allocated``
    after ``reset_peak_memory_stats``); a model on the CPU has no such
    number and raises ``ValueError``. The steps update ``model.net``.
    """
    from .step import TrainConfig, init_train_state, make_train_step

    device = model.device
    if return_memory and device.type != "cuda":
        raise ValueError("peak device memory is measured on the card only")
    cfg = TrainConfig(multiplier_consistency=1.0)
    n = model.sliCQ.block_length * blocks
    frames = model.sliCQ.get_expected_frames(n)
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((batch, 1, n)) * 0.1).astype(np.float32)
    gt = (rng.uniform(size=(batch, model.sliCQ.n_bins, frames)) > 0.97
          ).astype(np.float32)
    audio = torch.from_numpy(audio).to(device)
    gt = torch.from_numpy(gt).to(device)

    step = make_train_step(model, cfg, mpe_batch_size=batch,
                           conv_backend=conv_backend)
    state = init_train_state(model, cfg)
    if return_memory:
        _sync(device)
        torch.cuda.reset_peak_memory_stats(device)
    first_loss = float(step(state, audio, gt, lr)["loss/total"])
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        step(state, audio, gt, lr)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    if return_memory:
        return best, first_loss, torch.cuda.max_memory_allocated(device)
    return best, first_loss
