"""The training step: loss composition, AdamW, grad telemetry.

Counterpart of ``timbre_trap_tpu/train/step.py`` for the packed backends.
Loss composition mirrors the reference trainer (``experiments/train.py:
404-464``): the batch is [MPE samples | audio-only samples]; reconstruction
loss runs on the full batch against the (no-grad) transform coefficients,
transcription + consistency losses run on the MPE prefix only.

In PyTorch's idiom the parameters live in ``model.net``: the step computes
the gradients by autograd (``p.grad`` holds them after the step), updates
the parameters in place, and returns the metrics dict under the JAX
package's keys. The optimizer state is a dict that the step updates in
place. Not ported yet: ``grad_accum_steps > 1`` (``optax.MultiSteps``) and
``shard_train_step`` (multi-GPU).
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..interop import hwio_params
from ..models.fused import TRAIN_BACKENDS, packed_to_nchw, packed_train_forward
from ..objectives import compute_transcription_loss
from ..ops.packed_conv import pack_nhwc

__all__ = ["TrainConfig", "TRAIN_AUDIO_SCALE", "AdamW", "make_optimizer",
           "make_loss_fn", "make_train_step", "init_train_state",
           "grad_norm_telemetry", "compact_audio", "compact_ground_truth"]

# int16 grid for compact trainer audio uploads: range +-8 covers the summed
# stems of the reference's mixing datasets with quantization 1/4096.
TRAIN_AUDIO_SCALE = 4096.0


def compact_audio(audio):
    """Quantize f32 audio to the fixed +-8 int16 upload grid (host side)."""
    return np.clip(np.rint(np.asarray(audio, np.float32) * TRAIN_AUDIO_SCALE),
                   -32768, 32767).astype(np.int16)


def compact_ground_truth(gt):
    """Quantize a [0,1] GT raster to dense uint8 for upload (host side)."""
    return np.rint(np.clip(np.asarray(gt, np.float32), 0.0, 1.0)
                   * 255.0).astype(np.uint8)


@dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters of one training run (reference train.py:29-124)."""

    learning_rate: float = 1e-3
    weight_decay: float = 0.01           # torch AdamW default
    grad_clip: float = 10.0
    multiplier_reconstruction: float = 1.0
    multiplier_transcription: float = 1.0
    multiplier_consistency: float = 1.0
    weight_positive_class: bool = True
    transcription_active: bool = True    # False before n_epochs_late_start
    grad_accum_steps: int = 1


class AdamW:
    """The JAX package's optax chain, written out: ``clip_by_global_norm``
    -> ``scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) ->
    ``add_decayed_weights`` -> ``scale(-1)``, then times the learning rate.

    The clip scales by ``max_norm / norm`` only where ``norm >= max_norm``,
    as optax does (``torch.nn.utils.clip_grad_norm_`` would scale by
    ``max / (norm + 1e-6)``). The decay term ``-lr * wd * p`` is the same
    as ``torch.optim.AdamW``'s decoupled ``p * (1 - lr * wd)``; it is
    written here in optax's order so the step matches the JAX package to
    float32 rounding. Updates run in place, under ``no_grad``.
    """

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, grad_clip, weight_decay):
        self.grad_clip = float(grad_clip)
        self.weight_decay = float(weight_decay)

    def init(self, params):
        """Optimizer state for a {name: parameter} dict."""
        return {"count": 0,
                "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    @torch.no_grad()
    def update(self, params, grads, state, lr):
        """Apply one step to ``params`` and ``state`` in place."""
        norm = torch.sqrt(sum(torch.sum(torch.square(g))
                              for g in grads.values()))
        keep = norm < self.grad_clip
        state["count"] += 1
        count = np.float32(state["count"])
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** count)
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** count)
        for name, p in params.items():
            g = grads[name]
            g = torch.where(keep, g, (g / norm) * self.grad_clip)
            mu, nu = state["mu"][name], state["nu"][name]
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * torch.square(g) + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = (u + self.weight_decay * p) * -1.0
            p.add_(u * float(lr))


def make_optimizer(config: TrainConfig):
    """The optimizer of a run; ``grad_accum_steps > 1`` is not ported."""
    if config.grad_accum_steps > 1:
        raise NotImplementedError(
            "grad_accum_steps > 1 (optax.MultiSteps) is not ported yet")
    return AdamW(config.grad_clip, config.weight_decay)


def init_train_state(model, config: TrainConfig):
    """The optimizer state for ``model.net``'s parameters."""
    return make_optimizer(config).init(dict(model.net.named_parameters()))


def grad_norm_telemetry(grads):
    """Average/max per-leaf gradient norms for the encoder and decoder
    (reference utils/experiments.py:144-280, logged at train.py:474-490).
    ``grads`` maps parameter names to gradients."""
    metrics = {}
    for scope in ("encoder", "decoder"):
        leaves = [g for n, g in grads.items() if n.split(".")[0] == scope]
        norms = torch.stack([torch.linalg.vector_norm(g) for g in leaves])
        metrics[f"avg_norm/{scope}"] = torch.mean(norms)
        metrics[f"max_norm/{scope}"] = torch.max(norms)
    return metrics


def _recon_loss_packed(reconstructed, target):
    """Packed-layout (B, F*C, T) reconstruction loss — the row sum equals
    the reference's sum over channel+frequency."""
    return torch.mean(torch.sum(torch.square(reconstructed - target), dim=-2))


def make_loss_fn(model, config: TrainConfig, mpe_batch_size: int,
                 conv_backend="pallas_bf16"):
    """``loss_fn(features, ground_truth) -> (total, metrics)`` over the
    live parameters of ``model.net``, on one of the packed backends
    (``models/fused.py``: "pallas", "pallas_bf16", "packed")."""
    if conv_backend not in TRAIN_BACKENDS:
        raise ValueError(f"conv_backend must be one of "
                         f"{tuple(TRAIN_BACKENDS)}, not {conv_backend!r}")
    net = model.net
    consistency = bool(config.multiplier_consistency)

    def loss_fn(features, ground_truth):
        rec, _, trn, trn_rec, trn_scr = packed_train_forward(
            hwio_params(net), net, features, consistency, conv_backend)
        target = pack_nhwc(features)
        activations = model.to_activations(
            packed_to_nchw(trn, net.feature_size, net.in_channels))
        loss_rec = _recon_loss_packed(rec, target)
        loss_trn = compute_transcription_loss(activations[:mpe_batch_size],
                                              ground_truth,
                                              config.weight_positive_class)
        metrics = {"loss/reconstruction": loss_rec,
                   "loss/transcription": loss_trn}
        total = config.multiplier_reconstruction * loss_rec
        if consistency:
            target_c = trn[:mpe_batch_size]
            loss_sp = _recon_loss_packed(trn_rec[:mpe_batch_size], target_c)
            loss_sc = _recon_loss_packed(trn_scr[:mpe_batch_size], target_c)
            metrics["loss/consistency/spectral"] = loss_sp
            metrics["loss/consistency/score"] = loss_sc
        if config.transcription_active:
            total = total + config.multiplier_transcription * loss_trn
            if consistency:
                total = total + config.multiplier_consistency * (loss_sp
                                                                 + loss_sc)
        metrics["loss/total"] = total
        return total, metrics

    return loss_fn


def make_train_step(model, config: TrainConfig, mpe_batch_size: int,
                    conv_backend="pallas_bf16", compact_audio_grid=False):
    """Build the train step for a ``TimbreTrap`` of this package.

    ``step(opt_state, audio, ground_truth, lr) -> metrics``: ``audio`` is
    (B, 1, N) with the first ``mpe_batch_size`` samples annotated,
    ``ground_truth`` (mpe_batch_size, F, T_frames); both may be numpy
    arrays or tensors and move to the model's device (the card unless the
    model was built with ``device="cpu"``). The step sets ``p.grad`` of
    every parameter of ``model.net``, updates the parameters and
    ``opt_state`` in place, drops the model's cached inference chains (they
    hold the old weights) and returns the metrics (0-dim tensors, without a
    host sync) under the JAX package's keys.

    ``conv_backend``: "pallas_bf16" (the training CLI's default: K1/K3 with
    bfloat16 storage, float32 accumulation), "pallas" (K1/K3 in float32) or
    "packed" (autograd through the plain twin, float32).

    ``compact_audio_grid``: int16 audio means the compact ±8 upload grid
    (/TRAIN_AUDIO_SCALE, ``compact_audio``), as the Trainer uploads it;
    otherwise int16 means PCM16 (/32768). uint8 ground truth is /255.

    ``step.parts`` is ``(upload, loss_fn, update)``, the step's own parts,
    for tools that time them one by one: ``step`` is ``upload`` (batch to
    the device, features, gradients cleared), ``loss_fn``,
    ``total.backward()``, ``update`` (telemetry, optimizer, cache drop).
    """
    loss_fn = make_loss_fn(model, config, mpe_batch_size, conv_backend)
    optimizer = make_optimizer(config)
    params = dict(model.net.named_parameters())

    def upload(audio, ground_truth):
        audio = torch.as_tensor(audio).to(model.device)
        if compact_audio_grid and audio.dtype == torch.int16:
            audio = audio.to(torch.float32) * (1.0 / TRAIN_AUDIO_SCALE)
        features = model.features_from_audio(audio)
        ground_truth = torch.as_tensor(ground_truth).to(model.device)
        if ground_truth.dtype == torch.uint8:
            ground_truth = ground_truth.to(torch.float32) * (1.0 / 255.0)
        for p in params.values():
            p.grad = None
        return features, ground_truth

    def update(opt_state, metrics, lr):
        grads = {n: p.grad for n, p in params.items()}
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(grad_norm_telemetry(grads))
        optimizer.update(params, grads, opt_state, lr)
        model.invalidate_specs()
        metrics["learning_rate"] = torch.tensor(float(lr), dtype=torch.float32)
        return metrics

    def step(opt_state, audio, ground_truth, lr):
        total, metrics = loss_fn(*upload(audio, ground_truth))
        total.backward()
        return update(opt_state, metrics, lr)

    step.parts = (upload, loss_fn, update)
    return step
