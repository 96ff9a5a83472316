"""The full training loop (reference: experiments/train.py:127-588).

Counterpart of ``timbre_trap_tpu/train/loop.py``: a host-side shell around
the train step (``train/step.py``): mixed MPE + audio-only batch
composition, cosine warmup x plateau decay, checkpoint-every-N-batches with
validation sweeps through ``eval.evaluate``, best-model tracking, early
stopping and exact resume. Config is a dataclass dumped to JSON in the run
directory beside ``run.json``, ``metrics.json`` and a ``_sources/``
snapshot of this package (the sacred-equivalent run record).

In PyTorch's idiom the parameters live in ``model.net`` and the step
updates them and the optimizer state in place. Batches are composed (and,
for the card, pinned) on a prefetch thread; every CUDA call (the copy
stream, the copies, the events) stays on the main thread.

Data-parallel training (``n_devices``) runs one process per device, as
PyTorch does (the JAX package drives its mesh from one process): every
rank of a ``torch.distributed`` group of ``n_devices`` ranks builds the
same Trainer on its own device, loads only its rows of each global batch
(``parallel.plan_local_rows`` wired into the loaders' ``batch_rows``; all
ranks draw the same shuffled order, keyed by (seed, epoch)), and runs the
sharded step, which all-reduces the gradients. Rank 0 alone runs the
validation sweeps and broadcasts their results, so every rank takes the
same plateau, early-stop and best-model decisions in lockstep; rank 0
alone writes the run directory (``config.json``, ``run.json``,
``metrics.json``, ``_sources/``, checkpoints).
"""

import dataclasses
import json
import math
import os
import shutil
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data import constants
from ..data.loader import device_prefetch
from ..eval.evaluation import evaluate
from ..parallel import distributed
from ..parallel.mesh import make_mesh, plan_local_rows, torchrun_hint
from ..utils.profiling import span
from .checkpoint import load_checkpoint, save_checkpoint
from .schedules import PlateauDecay, cosine_warmup
from .step import (TrainConfig, compact_audio, compact_ground_truth,
                   init_train_state, make_train_step, shard_train_step)

__all__ = ["TrainerConfig", "Trainer"]


@dataclass
class TrainerConfig:
    """Run-level hyperparameters (reference train.py:29-124), with the JAX
    package's field names and defaults."""

    max_epochs: int = 5000
    checkpoint_interval: int = 250
    batch_size: int = 8
    n_secs: float = 9.0
    learning_rate: float = 1e-3
    multipliers: dict = field(default_factory=lambda: {
        "reconstruction": 1, "transcription": 1, "consistency": 1})
    n_epochs_warmup: int = 50
    validation_criteria_set: str = "URMP"
    validation_criteria_metric: str = "mpe/f1-score"
    validation_criteria_maximize: bool = True
    n_epochs_late_start: int = 0
    n_epochs_decay: int = 500
    n_epochs_cooldown: int = 100
    n_epochs_early_stop: Optional[int] = None
    # Data-parallel over a process group of this many ranks, one process
    # per device (None: one device, no group needed).
    n_devices: Optional[int] = None
    # Train step backend (train/step.py): "flax" (autograd through the NCHW
    # network), "packed" (the packed levels' plain twin), "pallas" (K1/K3,
    # float32) or "pallas_bf16" (K1/K3, bf16 storage, float32 accumulation).
    conv_backend: str = "flax"
    # Optimizer surface (reference train.py:334: torch AdamW defaults).
    weight_decay: float = 0.01
    # Average gradients over k step() calls before applying the update.
    grad_accum_steps: int = 1
    # Quantize batch uploads (audio -> int16 on a fixed ±8 grid, ground
    # truth -> uint8/255; dequantized on the device). Exact for {0,1}
    # ground truth; q <= 2.4e-4 on audio.
    compact_uploads: bool = True
    seed: int = 2
    root_dir: str = "runs"

    def dump(self, path):
        with open(path, "w") as fh:
            json.dump(dataclasses.asdict(self), fh, indent=2, default=str)


def _copy_into(dst, src):
    """Copy the nested dict ``src`` into ``dst`` in place: tensors by
    ``copy_``, anything else by assignment."""
    for key, value in src.items():
        if isinstance(value, dict):
            _copy_into(dst[key], value)
        elif isinstance(value, torch.Tensor):
            dst[key].copy_(value)
        else:
            dst[key] = value


class Trainer:
    """Imperative training shell; all device math lives in the train step."""

    def __init__(self, model, mpe_loader, audio_loader, validation_sets,
                 config: TrainerConfig, writer=None):
        self.model = model
        self.mpe_loader = mpe_loader
        self.audio_loader = audio_loader
        self.validation_sets = validation_sets
        self.config = config
        self.writer = writer
        self.mesh = self._make_mesh(config.n_devices, model.device)
        self.is_chief = distributed.process_index() == 0

        self.log_dir = os.path.join(config.root_dir, "models")
        self._metrics_log = {}
        if self.is_chief:
            os.makedirs(self.log_dir, exist_ok=True)
            config.dump(os.path.join(config.root_dir, "config.json"))
            # Sacred-parity run record (reference experiments/train.py:124
            # — FileStorageObserver folders carry config.json, run.json,
            # metrics.json and _sources/ copies of the executed code).
            self._write_run_record()
            self._snapshot_sources()

        self.mpe_batch_size = mpe_loader.batch_size
        # Each rank loads and composes only its rows of every global batch
        # (all ranks draw the same shuffled order), and its step composes
        # the losses over its m/n MPE rows.
        self._local_plan = None
        self._step_mpe_rows = self.mpe_batch_size
        if distributed.is_multi_host():
            audio_bs = audio_loader.batch_size if audio_loader else 0
            self._local_plan = plan_local_rows(self.mpe_batch_size, audio_bs)
            mpe_loader.batch_rows = self._local_plan.mpe_rows
            if audio_loader is not None:
                audio_loader.batch_rows = self._local_plan.audio_rows
            self._step_mpe_rows = len(self._local_plan.gt_pos)
        self.epoch_steps = len(mpe_loader)
        if audio_loader is not None:
            self.epoch_steps = min(self.epoch_steps, len(audio_loader))

        c = config
        self.n_ckpt_cooldown = math.ceil(
            c.n_epochs_cooldown * self.epoch_steps / c.checkpoint_interval)
        self.n_ckpt_decay = math.ceil(
            c.n_epochs_decay * self.epoch_steps / c.checkpoint_interval)
        self.n_ckpt_early_stop = None if c.n_epochs_early_stop is None else \
            math.ceil(c.n_epochs_early_stop * self.epoch_steps
                      / c.checkpoint_interval)

        self.warmup = cosine_warmup(c.n_epochs_warmup * self.epoch_steps)
        self.plateau = PlateauDecay(patience=self.n_ckpt_decay,
                                    cooldown=self.n_ckpt_cooldown,
                                    maximize=c.validation_criteria_maximize)

        self._steps = {}
        self.opt_state = init_train_state(
            model, self._train_config(transcription_active=True))
        self.batch_count = 0
        self.best_results = None
        self.best_checkpoint = None
        self.n_ckpt_elapsed = 0
        self._cuda = model.device.type == "cuda"
        self._copy_stream = None

    @staticmethod
    def _make_mesh(n_devices, device):
        """The data mesh of ``n_devices`` ranks, or None for one device
        without a process group. A process group must have exactly
        ``n_devices`` ranks, and a model on the card must sit on this
        rank's device."""
        if n_devices is None:
            if distributed.is_multi_host():
                raise ValueError("a process group of several ranks trains "
                                 "data-parallel: set n_devices to its size")
            return None
        n = int(n_devices)
        if n == 1 and not dist.is_initialized():
            return None
        if distributed.process_count() != n:
            raise ValueError(
                f"n_devices={n} trains data-parallel over {n} processes, one "
                f"per device; this process has "
                f"{distributed.process_count()} rank(s). Start {n} ranks "
                f"as: {torchrun_hint(n)}")
        if device.type == "cuda":
            here = torch.cuda.current_device()
            if (device.index if device.index is not None else here) != here:
                raise ValueError(f"the model sits on {device}, but this "
                                 f"rank's device is cuda:{here}")
        return make_mesh(n)

    @property
    def params(self):
        """{name: parameter} of ``model.net``, which the step updates in
        place."""
        return dict(self.model.net.named_parameters())

    # ------------------------------------------------------------------ #

    def _write_run_record(self):
        """run.json: invocation + environment (sacred run.json parity)."""
        device = self.model.device
        record = {
            "argv": list(sys.argv),
            "start_time": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "python": sys.version.split()[0],
            "torch": torch.__version__,
            "device": str(device),
            "device_name": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
            "n_processes": distributed.process_count(),
        }
        with open(os.path.join(self.config.root_dir, "run.json"), "w") as fh:
            json.dump(record, fh, indent=2)

    def _snapshot_sources(self):
        """Copy the executed sources into ``_sources/`` (sacred parity:
        the reference's run folders carry the exact code that produced the
        run). Snapshots the entry script and the ``timbre_trap_tpu_torch``
        package's .py files (not its kernel ``build/`` directory); skipped
        if the snapshot already exists (resume into the same run
        directory)."""
        dst = os.path.join(self.config.root_dir, "_sources")
        if os.path.isdir(dst):
            return
        os.makedirs(dst)
        script = sys.argv[0] if sys.argv else None
        if script and os.path.isfile(script):
            shutil.copy2(script, os.path.join(dst, os.path.basename(script)))
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        for root, dirs, files in os.walk(pkg_root):
            if root == pkg_root:
                dirs[:] = [d for d in dirs if d != "build"]
            rel = os.path.relpath(root, os.path.dirname(pkg_root))
            for f in files:
                if f.endswith(".py"):
                    os.makedirs(os.path.join(dst, rel), exist_ok=True)
                    shutil.copy2(os.path.join(root, f),
                                 os.path.join(dst, rel, f))

    def _record_metrics(self, results_by_set):
        """Append validation metrics to metrics.json (sacred format:
        {name: {"steps": [...], "values": [...]}}), one point per
        checkpoint sweep."""
        for set_name, results in results_by_set.items():
            for key, value in results.items():
                entry = self._metrics_log.setdefault(
                    f"{set_name}/{key}", {"steps": [], "values": []})
                entry["steps"].append(self.batch_count)
                entry["values"].append(float(value))
        with open(os.path.join(self.config.root_dir, "metrics.json"),
                  "w") as fh:
            json.dump(self._metrics_log, fh, indent=2)

    def _train_config(self, transcription_active):
        m = self.config.multipliers
        return TrainConfig(
            learning_rate=self.config.learning_rate,
            weight_decay=self.config.weight_decay,
            grad_accum_steps=self.config.grad_accum_steps,
            multiplier_reconstruction=m.get("reconstruction", 1),
            multiplier_transcription=m.get("transcription", 1),
            multiplier_consistency=m.get("consistency", 1),
            transcription_active=transcription_active,
        )

    def _get_step(self, transcription_active):
        """The train step of each late-start phase, built once."""
        key = bool(transcription_active)
        if key not in self._steps:
            step = make_train_step(
                self.model, self._train_config(key), self._step_mpe_rows,
                conv_backend=self.config.conv_backend,
                compact_audio_grid=True)
            if self.mesh is not None:
                step = shard_train_step(step, self.mesh)
            self._steps[key] = step
        return self._steps[key]

    # ---------------------------- resume ------------------------------- #

    def _trainer_state(self):
        """Host-side scalars the step checkpoint does not carry — plateau
        decay progress, best tracking, early-stop counter. The reference
        loses all of these on restart (train.py:153-164); persisting them
        makes resume exact."""
        p = self.plateau
        return {
            "batch_count": self.batch_count,
            "plateau": {"scale": p.scale, "best": p.best,
                        "num_bad": p.num_bad,
                        "cooldown_counter": p.cooldown_counter},
            "best_checkpoint": self.best_checkpoint,
            "best_results": self.best_results,
            "n_ckpt_elapsed": self.n_ckpt_elapsed,
        }

    def restore(self, ckpt_path):
        """Resume exactly from a trainer checkpoint directory.

        Loads the parameters into ``model.net`` and the optimizer state
        into ``self.opt_state``, in place (the steps already built hold
        them), drops the model's cached inference chains, and restores the
        trainer-state JSON saved next to the checkpoint; a resumed ``run()``
        then matches an uninterrupted one bit for bit (given deterministic
        loaders). Returns the batch count.
        """
        state = load_checkpoint(ckpt_path, map_location=self.model.device)
        self.model.net.load_state_dict(state["params"])
        _copy_into(self.opt_state, state["opt_state"])
        self.model.invalidate_specs()
        self.batch_count = int(state["step"])

        meta_path = f"{ckpt_path}.trainer.json"
        if os.path.exists(meta_path):
            with open(meta_path) as fh:
                meta = json.load(fh)
            self.batch_count = int(meta["batch_count"])
            pl = meta["plateau"]
            self.plateau.scale = float(pl["scale"])
            self.plateau.best = pl["best"]
            self.plateau.num_bad = int(pl["num_bad"])
            self.plateau.cooldown_counter = int(pl["cooldown_counter"])
            self.best_checkpoint = meta["best_checkpoint"]
            self.best_results = meta["best_results"]
            self.n_ckpt_elapsed = int(meta["n_ckpt_elapsed"])
        return self.batch_count

    def _compose_batch(self, data_mpe, data_audio):
        """Host-side numpy composition of one training batch, on the
        prefetch thread: [MPE audio | audio-only audio] and the MPE ground
        truth (on a rank of a data-parallel run, the loaders deliver only
        its rows, whose composition is this rank's part of the global
        batch). With ``compact_uploads`` (default) the audio is quantized to
        int16 on a fixed ±8 grid and the [0, 1] ground truth to uint8 for
        the copy to the device; the step dequantizes there, keeping the
        {0, 1} endpoints exact for the positive-class weighting."""
        audio = np.asarray(data_mpe[constants.KEY_AUDIO], np.float32)
        gt = np.asarray(data_mpe[constants.KEY_GROUND_TRUTH], np.float32)
        if data_audio:
            audio = np.concatenate(
                [audio, np.asarray(data_audio[constants.KEY_AUDIO],
                                   np.float32)], axis=0)
        if self.config.compact_uploads:
            audio = compact_audio(audio)
            gt = compact_ground_truth(gt)
        return audio, gt

    def _transfer(self, batch):
        """A staged host batch -> (audio, ground truth, copy event) on the
        model's device, on the main thread.

        On the card the batch arrives pinned from the prefetch thread; the
        copies run on a side stream after the work already queued on the
        current stream (which may have freed the blocks they write), and
        the step waits for the returned event before it reads them. Issued
        right after the step on the previous batch, the copy overlaps that
        step. On the CPU the arrays are wrapped as they are (no event).
        """
        audio, gt = batch
        if not self._cuda:
            return torch.as_tensor(audio), torch.as_tensor(gt), None
        device = self.model.device
        main = torch.cuda.current_stream(device)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device)
        dev = [torch.empty(t.shape, dtype=t.dtype, device=device)
               for t in (audio, gt)]
        self._copy_stream.wait_stream(main)
        with torch.cuda.stream(self._copy_stream):
            for d, t in zip(dev, (audio, gt)):
                d.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return dev[0], dev[1], done

    def _epoch_batches(self, epoch, start_epoch, skip_batches):
        """Composed host batches for one epoch (resume-aware skipping).

        With a dual loader the epoch truncates to the SHORTER loader
        (reference ``zip(loader, audio_loader)``, train.py:388) — never
        emit an MPE-only batch mid-epoch, which would silently change the
        batch shape and desync ``batch_count`` from ``epoch_steps``'s
        resume/warmup math.
        """
        audio_iter = iter(self.audio_loader) if self.audio_loader else None
        for i, data_mpe in enumerate(self.mpe_loader):
            if i >= self.epoch_steps:
                break
            data_audio = next(audio_iter, None) if audio_iter else None
            if audio_iter is not None and data_audio is None:
                break  # audio loader exhausted early (shorter than advertised)
            if epoch == start_epoch and i < skip_batches:
                continue
            yield self._compose_batch(data_mpe, data_audio)

    def _log(self, metrics):
        if self.writer is None or not self.is_chief:
            return
        for key, value in metrics.items():
            self.writer.add_scalar(f"train/{key}", float(value),
                                   self.batch_count)

    # ------------------------------------------------------------------ #

    def run(self):
        """Full training run; returns (best_checkpoint, best_results).

        Safe to call after :meth:`restore`: completed epochs are skipped and
        the first resumed epoch fast-forwards past the batches already
        trained (loaders are re-iterated, so exactness additionally needs
        per-epoch-deterministic loaders)."""
        c = self.config
        early_stop = False
        start_epoch = self.batch_count // self.epoch_steps
        skip_batches = self.batch_count % self.epoch_steps

        for epoch in range(start_epoch, c.max_epochs):
            transcription_active = epoch >= c.n_epochs_late_start
            step_fn = self._get_step(transcription_active)

            # Key each loader's shuffle by (seed, epoch): a resumed run then
            # reshuffles epoch k exactly as the uninterrupted run did.
            for loader in (self.mpe_loader, self.audio_loader):
                if loader is not None and hasattr(loader, "set_epoch"):
                    loader.set_epoch(epoch)

            # Batch composition (and pinning, for the card) rides a prefetch
            # thread; the main thread issues batch k+1's copy right after
            # the step on batch k, so the copy overlaps the step.
            batches = device_prefetch(
                self._epoch_batches(epoch, start_epoch, skip_batches),
                depth=2, pin_memory=self._cuda)
            dev = None
            try:
                with span("tt.loader.wait"):
                    nxt = next(batches, None)
                dev = self._transfer(nxt) if nxt is not None else None
                while dev is not None:
                    audio, gt, done = dev
                    if done is not None:
                        torch.cuda.current_stream(
                            self.model.device).wait_event(done)
                    self.batch_count += 1

                    # host-side schedule math: no device round trip per step
                    lr = c.learning_rate * float(
                        self.warmup(self.batch_count - 1))
                    lr *= self.plateau.scale

                    metrics = step_fn(self.opt_state, audio, gt, lr)
                    with span("tt.loader.wait"):
                        nxt = next(batches, None)
                    dev = self._transfer(nxt) if nxt is not None else None
                    self._log(metrics)

                    if self.batch_count % c.checkpoint_interval == 0:
                        self.n_ckpt_elapsed = self._checkpoint_and_validate(
                            epoch, self.n_ckpt_elapsed)
                        if (self.n_ckpt_early_stop is not None
                                and self.n_ckpt_elapsed
                                >= self.n_ckpt_early_stop):
                            early_stop = True
                            break
            finally:
                batches.close()
                if dev is not None and dev[2] is not None:
                    dev[2].synchronize()  # no copy left in flight
            if early_stop:
                break

        return self.best_checkpoint, self.best_results

    def _checkpoint_and_validate(self, epoch, n_ckpt_elapsed):
        self.model.invalidate_specs()  # inference runs the new weights
        ckpt_path = os.path.join(self.log_dir, f"model-{self.batch_count}")
        if self.is_chief:
            # Make every run's checkpoints self-describing: load_model
            # rebuilds the exact trained configuration (variant,
            # skip_connections, transform) from this run-level hparams.json.
            hparams_path = os.path.join(self.log_dir, "hparams.json")
            if not os.path.isfile(hparams_path):
                with open(hparams_path, "w") as fh:
                    json.dump(self.model.hparams, fh, indent=2)
            save_checkpoint(ckpt_path, self.model, self.opt_state,
                            self.batch_count)
        n_ckpt_elapsed = self._validate_and_track(epoch, n_ckpt_elapsed)
        # Persist the host-side trainer scalars next to the step checkpoint
        # AFTER plateau/best updates so restore() resumes exactly.
        self.n_ckpt_elapsed = n_ckpt_elapsed
        if self.is_chief:
            with open(f"{ckpt_path}.trainer.json", "w") as fh:
                json.dump(self._trainer_state(), fh, indent=2, default=float)
        return n_ckpt_elapsed

    def _validation_results(self):
        """Every validation set's results through ``evaluate``. In a
        data-parallel run rank 0 evaluates (every rank holds the same
        weights) and broadcasts the results, so every rank takes the same
        decisions on the same numbers."""
        c = self.config
        results = {}
        if self.is_chief:
            for val_set in self.validation_sets:
                results[val_set.name()] = evaluate(
                    model=self.model, eval_set=val_set,
                    multipliers=c.multipliers, writer=self.writer,
                    i=self.batch_count)
        if self.mesh is not None:
            box = [results]
            dist.broadcast_object_list(
                box, src=0, group=self.mesh.get_group())
            results = box[0]
        return results

    def _validate_and_track(self, epoch, n_ckpt_elapsed):
        c = self.config

        validation_results = self._validation_results()
        if validation_results and self.is_chief:
            self._record_metrics(validation_results)

        warmup_active = self.batch_count < c.n_epochs_warmup * self.epoch_steps
        if (self.n_ckpt_decay and not warmup_active
                and epoch >= c.n_epochs_late_start and validation_results):
            score = validation_results[c.validation_criteria_set][
                c.validation_criteria_metric]
            self.plateau.step(score)

        current = validation_results.get(c.validation_criteria_set, {}).get(
            c.validation_criteria_metric)
        if current is not None:
            best = None if self.best_results is None else \
                self.best_results[c.validation_criteria_set][
                    c.validation_criteria_metric]
            improved = best is None or (
                current > best if c.validation_criteria_maximize
                else current < best)
            if improved:
                self.best_checkpoint = self.batch_count
                self.best_results = validation_results
                return 0
            return n_ckpt_elapsed + 1
        return n_ckpt_elapsed
