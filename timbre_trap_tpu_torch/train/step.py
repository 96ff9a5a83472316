"""The training step: loss composition, AdamW, gradient accumulation,
grad telemetry.

Counterpart of ``timbre_trap_tpu/train/step.py``: the packed backends and
``"flax"`` (autograd through the NCHW network).
Loss composition mirrors the reference trainer (``experiments/train.py:
404-464``): the batch is [MPE samples | audio-only samples]; reconstruction
loss runs on the full batch against the (no-grad) transform coefficients,
transcription + consistency losses run on the MPE prefix only.

In PyTorch's idiom the parameters live in ``model.net``: the step computes
the gradients by autograd (``p.grad`` holds them after the step), updates
the parameters in place, and returns the metrics dict under the JAX
package's keys. The optimizer state is a dict that the step updates in
place; with ``grad_accum_steps > 1`` it also holds the gradient
accumulator (``MultiSteps``, the port of ``optax.MultiSteps``). Every
family, with or without skip connections, trains on every backend.

``shard_train_step`` makes a step data-parallel over the ranks of a
``torch.distributed`` group (one process per device): each rank computes
its rows' losses and gradients, and one all-reduce of every gradient (and
the losses) sits between the backward pass and the optimizer, where the
JAX package's sharded jit lets XLA emit it.
"""

import copy
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..device import ieee_convs
from ..interop import hwio_params
from ..models.fused import TRAIN_BACKENDS, packed_to_nchw, packed_train_forward
from ..objectives import compute_transcription_loss
from ..ops.packed_conv import pack_nchw, pack_nhwc
from ..parallel.mesh import DATA_AXIS
from ..utils.profiling import span

__all__ = ["TrainConfig", "TRAIN_AUDIO_SCALE", "AdamW", "MultiSteps",
           "make_optimizer",
           "make_loss_fn", "make_train_step", "shard_train_step",
           "init_train_state",
           "step_gradients_reference",
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


class MultiSteps:
    """``optax.MultiSteps`` over an inner optimizer (``AdamW``), with its
    default running mean: each call folds the gradients into the
    accumulator, ``acc + (g - acc) / (mini_step + 1)``; calls 1 .. k-1
    leave the parameters and the inner state as they are (a zero update);
    call k applies the inner optimizer once to the mean (its count
    advances once every k calls) and resets the accumulator. The state is
    the inner optimizer's dict plus ``mini_step`` and ``acc`` (a
    {name: tensor} dict)."""

    def __init__(self, inner, every_k):
        self.inner = inner
        self.every_k = int(every_k)

    def init(self, params):
        state = self.inner.init(params)
        state["mini_step"] = 0
        state["acc"] = {n: torch.zeros_like(p) for n, p in params.items()}
        return state

    @torch.no_grad()
    def update(self, params, grads, state, lr):
        """Fold ``grads`` in; on the k-th call, update ``params`` in place."""
        n = state["mini_step"]
        for name, g in grads.items():
            acc = state["acc"][name]
            acc.copy_(acc + (g - acc) / (n + 1))
        if n + 1 < self.every_k:
            state["mini_step"] = n + 1
            return
        self.inner.update(params, state["acc"], state, lr)
        for acc in state["acc"].values():
            acc.zero_()
        state["mini_step"] = 0


def make_optimizer(config: TrainConfig):
    """The optimizer of a run: ``AdamW``, under ``MultiSteps`` when
    ``grad_accum_steps > 1``."""
    tx = AdamW(config.grad_clip, config.weight_decay)
    if config.grad_accum_steps > 1:
        tx = MultiSteps(tx, config.grad_accum_steps)
    return tx


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


def _nchw_outputs(net, x, consistency):
    """The network's training outputs on NCHW features ``x``, through the
    plain NCHW modules with autograd: ``(reconstruction, transcription,
    transcription_rec, transcription_scr)`` packed f-major (the last two
    None without consistency)."""
    def encode(v):
        latents, embeddings = net.encode(v)
        return latents, net.apply_skip_connections(embeddings)

    def decode_pair(latents, skips):
        return [net.decode(latents, skips, t) for t in (False, True)]

    rec, trn = decode_pair(*encode(x))
    trn_rec = trn_scr = None
    if consistency:
        trn_rec, trn_scr = decode_pair(*encode(trn))
    return tuple(None if o is None else pack_nchw(o)
                 for o in (rec, trn, trn_rec, trn_scr))


def _compose_losses(model, config, mpe_batch_size, outputs, target,
                    ground_truth):
    """The reference trainer's loss composition on the packed outputs
    ``(reconstruction, transcription, transcription_rec,
    transcription_scr)`` (the last two None without consistency) against
    the packed features ``target``: ``(total, metrics)``."""
    net = model.net
    rec, trn, trn_rec, trn_scr = outputs
    consistency = trn_rec is not None
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
            total = total + config.multiplier_consistency * (loss_sp + loss_sc)
    metrics["loss/total"] = total
    return total, metrics


# Every backend of the step: the packed level backends, and "flax", the
# JAX package's name for autograd through the plain network's modules.
STEP_BACKENDS = tuple(TRAIN_BACKENDS) + ("flax",)


def make_loss_fn(model, config: TrainConfig, mpe_batch_size: int,
                 conv_backend="pallas_bf16"):
    """``loss_fn(features, ground_truth) -> (total, metrics)`` over the
    live parameters of ``model.net``, on one of the packed backends
    (``models/fused.py``: "pallas", "pallas_bf16", "packed") or through the
    NCHW network ("flax", float32)."""
    if conv_backend not in STEP_BACKENDS:
        raise ValueError(f"conv_backend must be one of {STEP_BACKENDS}, "
                         f"not {conv_backend!r}")
    net = model.net
    consistency = bool(config.multiplier_consistency)

    if conv_backend == "flax":
        def nchw_loss_fn(features, ground_truth):
            x = features.movedim(-1, 1)
            return _compose_losses(model, config, mpe_batch_size,
                                   _nchw_outputs(net, x, consistency),
                                   pack_nchw(x), ground_truth)

        return nchw_loss_fn

    def loss_fn(features, ground_truth):
        rec, _, trn, trn_rec, trn_scr = packed_train_forward(
            hwio_params(net), net, features, consistency, conv_backend)
        return _compose_losses(model, config, mpe_batch_size,
                               (rec, trn, trn_rec, trn_scr),
                               pack_nhwc(features), ground_truth)

    return loss_fn


def _upload_batch(model, audio, ground_truth, compact_audio_grid):
    """A batch on the model's device: features of the float32 audio and
    float32 ground truth (int16 audio on the compact grid or PCM16, uint8
    ground truth /255)."""
    audio = torch.as_tensor(audio).to(model.device)
    if compact_audio_grid and audio.dtype == torch.int16:
        audio = audio.to(torch.float32) * (1.0 / TRAIN_AUDIO_SCALE)
    features = model.features_from_audio(audio)
    ground_truth = torch.as_tensor(ground_truth).to(model.device)
    if ground_truth.dtype == torch.uint8:
        ground_truth = ground_truth.to(torch.float32) * (1.0 / 255.0)
    return features, ground_truth


def step_gradients_reference(model, config: TrainConfig, mpe_batch_size,
                             audio, ground_truth, dtype=torch.float64,
                             compact_audio_grid=False):
    """The gradients of one step's loss (the same batch, objectives and
    composition as ``make_train_step``) through a copy of the plain NCHW
    network at ``dtype`` (float64 by default), on the model's device: a
    yardstick for how far the float32 routes' gradients lie from exact
    arithmetic. Returns {parameter name: gradient}; ``model`` is left as
    it is."""
    net = copy.deepcopy(model.net).to(dtype)
    features, ground_truth = _upload_batch(model, audio, ground_truth,
                                           compact_audio_grid)
    x = features.to(dtype).movedim(-1, 1)
    outputs = _nchw_outputs(net, x, bool(config.multiplier_consistency))
    total, _ = _compose_losses(model, config, mpe_batch_size, outputs,
                               pack_nchw(x), ground_truth.to(dtype))
    names = [n for n, _ in net.named_parameters()]
    grads = torch.autograd.grad(total, list(net.parameters()))
    return dict(zip(names, grads))


def make_train_step(model, config: TrainConfig, mpe_batch_size: int,
                    conv_backend="pallas_bf16", compact_audio_grid=False):
    """Build the train step for a ``TimbreTrap`` of this package.

    Every family (``TimbreTrap``, ``TimbreTrapFiLM``, ``TimbreTrapMag``,
    ``TimbreTrapMagDB``), with or without skip connections.
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
    bfloat16 storage, float32 accumulation), "pallas" (K1/K3 in float32),
    "packed" (autograd through the plain twin, float32) or "flax"
    (``TrainerConfig``'s default: autograd through the NCHW network's
    modules, float32; on the card its cuDNN convolutions run without TF32).

    ``compact_audio_grid``: int16 audio means the compact ±8 upload grid
    (/TRAIN_AUDIO_SCALE, ``compact_audio``), as the Trainer uploads it;
    otherwise int16 means PCM16 (/32768). uint8 ground truth is /255.

    ``step.parts`` is ``(upload, loss_fn, update)``, the step's own parts,
    for tools that time them one by one: ``step`` is ``upload`` (batch to
    the device, features, gradients cleared), ``loss_fn``,
    ``total.backward()``, ``update`` (telemetry, optimizer, cache drop).
    ``step.model`` is ``model``.
    """
    loss_fn = make_loss_fn(model, config, mpe_batch_size, conv_backend)
    optimizer = make_optimizer(config)
    params = dict(model.net.named_parameters())

    def upload(audio, ground_truth):
        batch = _upload_batch(model, audio, ground_truth, compact_audio_grid)
        for p in params.values():
            p.grad = None
        return batch

    def update(opt_state, metrics, lr):
        grads = {n: p.grad for n, p in params.items()}
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(grad_norm_telemetry(grads))
        optimizer.update(params, grads, opt_state, lr)
        model.invalidate_specs()
        metrics["learning_rate"] = torch.tensor(float(lr), dtype=torch.float32)
        return metrics

    return _assemble_step(model, upload, loss_fn, update)


def _assemble_step(model, upload, loss_fn, update, reduce=None):
    """The step that runs its parts in order: ``upload``, ``loss_fn``,
    ``total.backward()``, ``reduce`` of the metrics (and the gradients) if
    given, ``update``, each one span (``tt.step.upload``, ``.forward``,
    ``.backward``, ``.reduce``, ``.update``). ``step.parts`` lists them;
    ``step.model`` is ``model``."""

    def step(opt_state, audio, ground_truth, lr):
        with ieee_convs(model.device):
            with span("tt.step.upload"):
                batch = upload(audio, ground_truth)
            with span("tt.step.forward"):
                total, metrics = loss_fn(*batch)
            with span("tt.step.backward"):
                total.backward()
        if reduce is not None:
            with span("tt.step.reduce"):
                metrics = reduce(metrics)
        with span("tt.step.update"):
            return update(opt_state, metrics, lr)

    step.parts = ((upload, loss_fn, update) if reduce is None
                  else (upload, loss_fn, reduce, update))
    step.model = model
    return step


def shard_train_step(step_fn, mesh):
    """The step ``step_fn`` of ``make_train_step``, data-parallel over the
    ranks of ``mesh`` (``parallel.make_mesh``).

    Every rank calls the returned step on its own rows of the global batch
    (``parallel.plan_local_rows``: m/n MPE rows then a/n audio-only rows,
    so ``step_fn`` is built with ``mpe_batch_size`` m/n). Between
    ``total.backward()`` and the update, every gradient and every loss
    metric is all-reduced (SUM) as one flat float32 buffer and divided by
    n: every loss is a mean over rows and each rank holds the same number
    of rows, so the ranks then hold the global batch's gradient and
    losses, as the JAX package's sharded step does. The optimizer's
    global-norm clip, the gradient telemetry and ``MultiSteps``
    accumulation (each call's gradients are reduced before they are
    folded) all see the global gradient, and every rank applies the same
    update to the same weights.

    ``net`` is not wrapped in ``DistributedDataParallel``: the packed
    backends never call ``net.forward``, whose wrapper DDP's reducer needs.
    ``step.parts`` is ``(upload, loss_fn, reduce, update)``.
    """
    upload, loss_fn, update = step_fn.parts
    model = step_fn.model
    params = dict(model.net.named_parameters())
    n = mesh.size()
    group = mesh.get_group(DATA_AXIS)

    def reduce(metrics):
        keys = sorted(metrics)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params.values()]
        flat = torch.cat([g.reshape(-1) for g in grads] + [torch.stack(
            [metrics[k].detach().to(torch.float32) for k in keys])])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(n)
        chunks = flat.split([g.numel() for g in grads] + [len(keys)])
        for p, g in zip(params.values(), chunks):
            p.grad = g.view_as(p)
        reduced = dict(zip(keys, chunks[-1].unbind()))
        return {k: reduced[k] for k in metrics}  # in the step's own order

    return _assemble_step(model, upload, loss_fn, update, reduce)
