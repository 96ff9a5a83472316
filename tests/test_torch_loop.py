"""The port's Trainer and evaluate() (timbre_trap_tpu_torch.train.loop and
.eval.evaluation) on the cases of ``tests/test_loop.py``, and against the
JAX package's on the same toy corpus, seeds and weights, on the CPU at the
small geometry (8 kHz, 5 octaves x 12 bins, 0.5-s blocks, latent 16,
complexity 1):

* ``evaluate``: the ``mpe/*`` results equal, every loss within 1e-4
  relative, the SDR within 1e-3 dB; the boundary-bin case of
  ``tests/test_eval.py``;
* the Trainer over 4 steps on the ``"flax"`` and ``"packed"`` backends:
  each step's ``loss/total`` within 1e-4 relative (read through a
  recording writer on both sides), the final parameters within
  5e-4 x each leaf's max|p|.

The data-parallel Trainer runs one process per device: in this one
process ``n_devices=2`` raises; its two-rank case is in
``tests/test_torch_parallel.py``.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

import jax

from timbre_trap_tpu.data import DataLoader as JaxDataLoader
from timbre_trap_tpu.data import MPEDataset as JaxMPEDataset
from timbre_trap_tpu.eval import evaluate as jax_evaluate
from timbre_trap_tpu.eval.evaluation import \
    masked_peak_estimates as jax_masked_peak_estimates
from timbre_trap_tpu.models import TimbreTrap as JaxTimbreTrap
from timbre_trap_tpu.train import Trainer as JaxTrainer
from timbre_trap_tpu.train import TrainerConfig as JaxTrainerConfig
from timbre_trap_tpu_torch.data import (AMTDataset, AudioDataset, DataLoader,
                                        MPEDataset, constants)
from timbre_trap_tpu_torch.data.io import save_wav
from timbre_trap_tpu_torch.eval import evaluate, signal_distortion_ratio
from timbre_trap_tpu_torch.eval.evaluation import masked_peak_estimates
from timbre_trap_tpu_torch.interop import state_dict_from_jax
from timbre_trap_tpu_torch.models import (TimbreTrap, TimbreTrapMagDB,
                                          load_model)
from timbre_trap_tpu_torch.train import (TrainConfig, Trainer, TrainerConfig,
                                         init_train_state, latest_checkpoint,
                                         load_checkpoint, make_train_step,
                                         save_checkpoint)
from timbre_trap_tpu_torch.transform.design import midi_to_hz

torch.set_num_threads(2)

SR = 8000
HP = dict(sample_rate=SR, n_octaves=5, bins_per_octave=12,
          secs_per_block=0.5, latent_size=16, model_complexity=1)
MULTIPLIERS = {"reconstruction": 1, "transcription": 1, "consistency": 1}


def _toy(base):
    class ToyMPE(base):
        @staticmethod
        def available_splits():
            return ["all"]

        def get_tracks(self, split):
            return sorted(f[:-4] for f in os.listdir(self.base_dir)
                          if f.endswith(".wav"))

        def get_audio_path(self, track):
            return os.path.join(self.base_dir, f"{track}.wav")

        def get_ground_truth_path(self, track):
            return os.path.join(self.base_dir, f"{track}.f0.npy")

        def get_ground_truth(self, track):
            d = np.load(self.get_ground_truth_path(track),
                        allow_pickle=True).item()
            return d["times"], [np.asarray(p) for p in d["pitches"]]

    return ToyMPE


ToyMPE = _toy(MPEDataset)
JaxToyMPE = _toy(JaxMPEDataset)


class ToyAudio(AudioDataset):
    @staticmethod
    def available_splits():
        return ["all"]

    def get_tracks(self, split):
        return sorted(f[:-4] for f in os.listdir(self.base_dir)
                      if f.endswith(".wav"))

    def get_audio_path(self, track):
        return os.path.join(self.base_dir, f"{track}.wav")


class Recorder:
    """A writer that records what the Trainer and evaluate log."""

    def __init__(self):
        self.scalars, self.images = [], []

    def add_scalar(self, key, value, i):
        self.scalars.append((key, float(value), i))

    def add_image(self, key, image, i):
        self.images.append((key, np.asarray(image).shape, i))

    def series(self, key):
        return [v for k, v, _ in self.scalars if k == key]


def _write_corpus(root):
    """``tests/test_loop.py``'s toy corpus: four 1.5-s tones with their f0."""
    for i, midi in enumerate([57.0, 60.0, 64.0, 69.0]):
        f = float(midi_to_hz(midi))
        n = int(1.5 * SR)
        audio = 0.5 * np.sin(2 * np.pi * f * np.arange(n) / SR)
        save_wav(str(root / f"tr{i}.wav"), audio.astype(np.float32), SR)
        times = np.arange(0, 1.5, 0.01)
        np.save(str(root / f"tr{i}.f0.npy"),
                {"times": times, "pitches": [np.array([f])] * len(times)})
    return str(root)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _write_corpus(tmp_path_factory.mktemp("corpus"))


@pytest.fixture(scope="module")
def jax_params():
    """The JAX package's initial weights of the small model, as numpy."""
    return jax.tree.map(np.asarray, JaxTimbreTrap(**HP).params)


@pytest.fixture()
def model(jax_params):
    m = TimbreTrap(**HP, device="cpu")
    m.load_jax_params(jax_params)
    return m


def _train_set(cls, corpus, cqt, n_secs=0.5):
    return cls(base_dir=corpus, splits=["all"], sample_rate=SR, cqt=cqt,
               n_secs=n_secs, seed=0)


# --------------------------------------------------------------------- #
# Metrics and checkpoints                                                #
# --------------------------------------------------------------------- #

def test_sdr_identical_signals(rng):
    x = rng.standard_normal((1, 4000))
    assert signal_distortion_ratio(x, x) > 80.0


def test_sdr_scaled_and_noisy(rng):
    x = rng.standard_normal(4000)
    assert signal_distortion_ratio(0.5 * x, x) > 80.0
    noisy = x + 0.1 * rng.standard_normal(4000)
    assert 15.0 < signal_distortion_ratio(noisy, x) < 25.0


def test_checkpoint_round_trip(tmp_path, model):
    state = init_train_state(model, TrainConfig())
    path = save_checkpoint(str(tmp_path / "model-10"), model, state, 10)
    loaded = load_checkpoint(path)
    assert int(loaded["step"]) == 10
    for name, p in model.net.state_dict().items():
        assert torch.equal(loaded["params"][name], p), name
    assert latest_checkpoint(str(tmp_path)) == path


# --------------------------------------------------------------------- #
# evaluate                                                               #
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def jax_results(corpus):
    """JAX evaluate of the small model's initial weights on the corpus."""
    m = JaxTimbreTrap(**HP)
    return jax_evaluate(m, _train_set(JaxToyMPE, corpus, m.sliCQ, None),
                        MULTIPLIERS)


def _assert_results_match(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        if key.startswith("mpe/"):
            assert got[key] == value, key
        elif key == "reconstruction/SDR":
            assert abs(got[key] - value) <= 1e-3, (key, got[key], value)
        else:
            assert got[key] == pytest.approx(value, rel=1e-4), key


def test_evaluate_matches_jax(model, corpus, jax_results):
    """``tests/test_loop.py::test_evaluate_on_toy_set`` on the port, held
    to the JAX package's evaluate with the same weights."""
    results = evaluate(model, _train_set(ToyMPE, corpus, model.sliCQ, None),
                       MULTIPLIERS)
    for key in ("mpe/f1-score", "reconstruction/SDR", "loss/total",
                "loss/consistency"):
        assert np.isfinite(results[key]), key
    _assert_results_match(results, jax_results)


def test_evaluate_logs_images_only_with_a_writer(model, corpus):
    """Scalars and the four images under the set's name with a writer; no
    consistency key without the consistency multiplier."""
    ds = _train_set(ToyMPE, corpus, model.sliCQ, None)
    writer = Recorder()
    results = evaluate(model, ds, dict(MULTIPLIERS, consistency=0),
                       writer=writer, i=7)
    assert "loss/consistency" not in results
    assert {k for k, _, _ in writer.scalars} == {
        f"ToyMPE/{k}" for k in results}
    assert [(k.split("/")[-1], i) for k, _, i in writer.images] == [
        ("magnitude CQT", 7), ("reconstruction", 7), ("ground-truth", 7),
        ("transcription", 7)]
    assert all(shape[:2] == (1, model.sliCQ.n_bins)
               for _, shape, _ in writer.images)


def test_evaluate_magnitude_families_report_no_sdr(corpus):
    """MagDB (a TimbreTrapMag) carries no phase: no SDR, the rest finite."""
    m = TimbreTrapMagDB(**HP, device="cpu")
    results = evaluate(m, _train_set(ToyMPE, corpus, m.sliCQ, None),
                       MULTIPLIERS)
    assert "reconstruction/SDR" not in results
    assert all(np.isfinite(v) for v in results.values())


def test_evaluate_reads_note_annotations(model, corpus):
    """An AMT (NoteDataset) set's reference pitches come from its notes."""
    class ToyNotes(AMTDataset, ToyMPE):
        def get_ground_truth(self, track):
            return np.array([60.0]), np.array([[0.0, 1.2]])

    ds = _train_set(ToyNotes, corpus, model.sliCQ, None)
    assert ds[0][constants.KEY_GROUND_TRUTH].shape[0] == model.sliCQ.n_bins
    results = evaluate(model, ds, MULTIPLIERS)
    assert np.isfinite(results["mpe/f1-score"])


def test_masked_peak_estimates_boundary_bin():
    """Invalid-frequency zeroing happens BEFORE peak-picking (reference
    evaluate.py:105-110), as in the JAX package: the same masks and
    warnings on ``tests/test_eval.py``'s boundary case."""
    F, T = 8, 4
    acts = np.zeros((1, F, T), np.float32)
    acts[0, 5] = 0.6   # valid boundary bin — a peak once bin 6 is zeroed
    acts[0, 6] = 0.9   # invalid bin (above MAX_FREQ), dominates bin 5
    invalid = np.zeros(F, bool)
    invalid[6:] = True

    with pytest.warns(RuntimeWarning, match="invalid frequencies"):
        mask = masked_peak_estimates(acts, invalid)
    assert mask.shape == (F, T) and mask.dtype == np.float64
    assert np.all(mask[5] == 1.0)
    assert not mask[invalid].any()
    with pytest.warns(RuntimeWarning, match="invalid frequencies"):
        np.testing.assert_array_equal(
            mask, jax_masked_peak_estimates(acts, invalid))

    acts2 = acts.copy()
    acts2[0, 6] = 0.0
    acts2[0, 4] = 0.9
    mask2 = masked_peak_estimates(torch.from_numpy(acts2), invalid)
    assert np.all(mask2[4] == 1.0) and not mask2[5].any()
    np.testing.assert_array_equal(mask2,
                                  jax_masked_peak_estimates(acts2, invalid))


# --------------------------------------------------------------------- #
# The Trainer against the JAX package's                                  #
# --------------------------------------------------------------------- #

def _parity_run(side, backend, corpus, root, jax_params=None):
    """4 steps (2 epochs x 2 shuffled batches of 0.5-s crops) of one
    package's Trainer from the JAX package's initial weights, recorded."""
    if side == "jax":
        m = JaxTimbreTrap(**HP)
        ds_cls, loader_cls = JaxToyMPE, JaxDataLoader
        trainer_cls, config_cls = JaxTrainer, JaxTrainerConfig
    else:
        m = TimbreTrap(**HP, device="cpu")
        m.load_jax_params(jax_params)
        ds_cls, loader_cls = ToyMPE, DataLoader
        trainer_cls, config_cls = Trainer, TrainerConfig
    loader = loader_cls(_train_set(ds_cls, corpus, m.sliCQ), batch_size=2,
                        shuffle=True, drop_last=True, seed=3)
    config = config_cls(max_epochs=2, checkpoint_interval=1000,
                        batch_size=2, n_secs=0.5, n_epochs_warmup=1,
                        conv_backend=backend, root_dir=str(root))
    writer = Recorder()
    trainer = trainer_cls(m, loader, None, [], config, writer=writer)
    trainer.run()
    return trainer, writer


@pytest.fixture(scope="module", params=["flax", "packed"])
def jax_trainer_run(request, corpus, tmp_path_factory):
    """The JAX Trainer's 4 steps on a backend: (backend, logged scalars,
    final parameters as a reference-named state_dict)."""
    trainer, writer = _parity_run("jax", request.param, corpus,
                                  tmp_path_factory.mktemp("jax_run"))
    params = jax.tree.map(np.asarray, trainer.params)
    return request.param, writer, state_dict_from_jax(params)


def test_trainer_matches_jax(jax_trainer_run, jax_params, corpus, tmp_path):
    backend, want_writer, want_params = jax_trainer_run
    trainer, writer = _parity_run("torch", backend, corpus, tmp_path / "run",
                                  jax_params)
    assert trainer.batch_count == 4
    got, want = (writer.series("train/loss/total"),
                 want_writer.series("train/loss/total"))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g == pytest.approx(w, rel=1e-4), (got, want)
    assert writer.series("train/learning_rate") == pytest.approx(
        want_writer.series("train/learning_rate"), rel=1e-6)
    assert {k for k, _, _ in writer.scalars} == {
        k for k, _, _ in want_writer.scalars}
    for name, p in trainer.model.net.state_dict().items():
        want = want_params[name].numpy()
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(p.numpy(), want, atol=5e-4 * scale,
                                   err_msg=name)


# --------------------------------------------------------------------- #
# The Trainer's own contracts                                            #
# --------------------------------------------------------------------- #

def test_trainer_end_to_end(model, corpus, tmp_path):
    train_set = _train_set(ToyMPE, corpus, model.sliCQ)
    val_set = _train_set(ToyMPE, corpus, model.sliCQ, None)
    loader = DataLoader(train_set, batch_size=2, shuffle=True, drop_last=True)
    config = TrainerConfig(max_epochs=2, checkpoint_interval=2, batch_size=2,
                           n_secs=0.5, learning_rate=1e-3, n_epochs_warmup=1,
                           validation_criteria_set="ToyMPE",
                           conv_backend="pallas_bf16",
                           root_dir=str(tmp_path / "run"))
    trainer = Trainer(model, loader, None, [val_set], config)
    best_ckpt, best_results = trainer.run()

    assert trainer.batch_count == 4
    assert best_ckpt in (2, 4)
    assert "ToyMPE" in best_results
    models_dir = os.path.join(config.root_dir, "models")
    for name in ("model-2", "model-4"):
        assert os.path.isdir(os.path.join(models_dir, name))
        assert os.path.isfile(os.path.join(models_dir, f"{name}.trainer.json"))
    assert os.path.exists(os.path.join(config.root_dir, "config.json"))
    with open(os.path.join(config.root_dir, "run.json")) as fh:
        record = json.load(fh)
    assert record["torch"] == torch.__version__ and record["device"] == "cpu"
    with open(os.path.join(config.root_dir, "metrics.json")) as fh:
        metrics = json.load(fh)
    key = "ToyMPE/mpe/f1-score"
    assert metrics[key]["steps"] == [2, 4]
    assert len(metrics[key]["values"]) == 2
    assert os.path.isfile(os.path.join(
        config.root_dir, "_sources", "timbre_trap_tpu_torch", "train",
        "loop.py"))
    assert not os.path.isdir(os.path.join(
        config.root_dir, "_sources", "timbre_trap_tpu_torch", "build"))
    # The last checkpoint rebuilds the trained model bit for bit.
    loaded = load_model(os.path.join(models_dir, "model-4"),
                        overrides={"device": "cpu"})
    for name, p in model.net.state_dict().items():
        assert torch.equal(loaded.net.state_dict()[name], p), name


def test_trainer_dual_loader(model, corpus, tmp_path):
    """MPE + audio-only loaders compose a mixed batch: audio-only rows are
    appended after the MPE rows and contribute reconstruction loss only
    (reference train.py:263-290,393-398); compact uploads stay on. With
    unequal loaders the epoch truncates to the shorter one."""
    mpe_set = _train_set(ToyMPE, corpus, model.sliCQ)
    audio_set = ToyAudio(base_dir=corpus, splits=["all"], sample_rate=SR,
                         n_secs=0.5, seed=1)
    mpe_loader = DataLoader(mpe_set, batch_size=2, drop_last=True)
    audio_loader = DataLoader(audio_set, batch_size=2, drop_last=True)
    config = TrainerConfig(max_epochs=1, checkpoint_interval=1000,
                           batch_size=4, n_secs=0.5, conv_backend="flax",
                           root_dir=str(tmp_path / "run_dual"))
    trainer = Trainer(model, mpe_loader, audio_loader, [], config)
    batches = list(trainer._epoch_batches(0, 0, 0))
    frames = model.sliCQ.get_expected_frames(4000)
    assert [(a.shape, a.dtype, g.shape, g.dtype) for a, g in batches] == [
        ((4, 1, 4000), np.dtype(np.int16), (2, model.sliCQ.n_bins, frames),
         np.dtype(np.uint8))] * 2
    trainer.run()
    assert trainer.batch_count == 2
    assert trainer.mpe_batch_size == 2

    short_audio = DataLoader(audio_set, batch_size=4, drop_last=True)
    config2 = TrainerConfig(max_epochs=2, checkpoint_interval=1000,
                            batch_size=4, n_secs=0.5, conv_backend="flax",
                            root_dir=str(tmp_path / "run_dual2"))
    trainer2 = Trainer(model, mpe_loader, short_audio, [], config2)
    assert trainer2.epoch_steps == 1
    trainer2.run()
    assert trainer2.batch_count == 2
    assert len(trainer2._steps) == 1


def test_trainer_spans_the_loader_wait_and_each_step(model, corpus,
                                                     tmp_path):
    """Under a profiler the Trainer's waits on the next batch are
    ``tt.loader.wait`` spans (one a step, and the wait that finds the
    epoch's end), beside each step's ``tt.step.*`` spans."""
    from timbre_trap_tpu_torch.utils import profiling

    loader = DataLoader(_train_set(ToyMPE, corpus, model.sliCQ),
                        batch_size=2, drop_last=True)
    config = TrainerConfig(max_epochs=1, checkpoint_interval=1000,
                           batch_size=2, n_secs=0.5,
                           conv_backend="pallas_bf16",
                           root_dir=str(tmp_path / "run_spans"))
    trainer = Trainer(model, loader, None, [], config)
    profiling.reset_record()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        trainer.run()
    rec = profiling.record()
    assert trainer.batch_count == 2
    assert rec["tt.loader.wait"]["count"] == 3
    for part in ("upload", "forward", "backward", "update"):
        assert rec[f"tt.step.{part}"]["count"] == 2, part


def test_trainer_data_parallel_waits_for_its_slice(model, corpus, tmp_path):
    """Data-parallel training runs one process per device, so in one
    process without a process group ``n_devices=2`` raises, names the
    ``torchrun`` command that starts two ranks and writes nothing;
    ``n_devices=1`` is one device with no group. The two-rank Trainer
    against ``tests/test_loop.py::test_trainer_data_parallel``'s bar is in
    ``tests/test_torch_parallel.py``."""
    loader = DataLoader(_train_set(ToyMPE, corpus, model.sliCQ),
                        batch_size=4, drop_last=True)
    config = TrainerConfig(n_devices=2, root_dir=str(tmp_path / "dp"))
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        Trainer(model, loader, None, [], config)
    assert not (tmp_path / "dp").exists()
    one = Trainer(model, loader, None, [], TrainerConfig(
        n_devices=1, conv_backend="flax", root_dir=str(tmp_path / "dp1")))
    assert one.mesh is None and one._local_plan is None
    assert loader.batch_rows is None


def test_trainer_late_start(model, corpus, tmp_path):
    loader = DataLoader(_train_set(ToyMPE, corpus, model.sliCQ),
                        batch_size=2, drop_last=True)
    config = TrainerConfig(max_epochs=1, checkpoint_interval=1000,
                           batch_size=2, n_secs=0.5, n_epochs_late_start=5,
                           conv_backend="flax",
                           root_dir=str(tmp_path / "run2"))
    trainer = Trainer(model, loader, None, [], config)
    trainer.run()
    assert list(trainer._steps.keys()) == [False]


def test_trainer_resume_is_exact(jax_params, corpus, tmp_path):
    """A run resumed from a mid-epoch checkpoint into a fresh model matches
    the uninterrupted run bit for bit: parameters, optimizer state, plateau
    state, best tracking. The loader reshuffles by (seed, epoch), so
    epoch 1 after the restore is the uninterrupted run's epoch 1."""
    def make_trainer(root):
        m = TimbreTrap(**HP, device="cpu")
        m.load_jax_params(jax_params)
        train_set = _train_set(ToyMPE, corpus, m.sliCQ, None)
        val_set = _train_set(ToyMPE, corpus, m.sliCQ, None)
        loader = DataLoader(train_set, batch_size=2, shuffle=True,
                            drop_last=True, seed=7)
        config = TrainerConfig(max_epochs=2, checkpoint_interval=1,
                               batch_size=2, n_secs=None, learning_rate=1e-3,
                               n_epochs_warmup=1, n_epochs_decay=1,
                               validation_criteria_set="ToyMPE",
                               conv_backend="flax",
                               root_dir=str(tmp_path / root))
        return Trainer(m, loader, None, [val_set], config)

    a = make_trainer("run_a")
    a.run()
    assert a.batch_count == 4

    b = make_trainer("run_b")
    ckpt3 = os.path.join(str(tmp_path / "run_a"), "models", "model-3")
    assert b.restore(ckpt3) == 3
    b.run()

    assert b.batch_count == a.batch_count
    assert b.best_checkpoint == a.best_checkpoint
    assert b.best_results == a.best_results
    assert (b.plateau.scale, b.plateau.best, b.plateau.num_bad) == \
        (a.plateau.scale, a.plateau.best, a.plateau.num_bad)
    assert b.n_ckpt_elapsed == a.n_ckpt_elapsed
    for name, p in a.params.items():
        assert torch.equal(b.params[name], p), name
    assert b.opt_state["count"] == a.opt_state["count"] == 4
    for name, mu in a.opt_state["mu"].items():
        assert torch.equal(b.opt_state["mu"][name], mu), name


def test_trainer_early_stop_closes_the_prefetch_thread(model, corpus,
                                                       tmp_path):
    """Early stop after the first checkpoint, mid-epoch: the run returns
    with no prefetch thread and no loader worker left."""
    before = set(threading.enumerate())
    loader = DataLoader(_train_set(ToyMPE, corpus, model.sliCQ), batch_size=1,
                        shuffle=True, drop_last=True, num_workers=2)
    config = TrainerConfig(max_epochs=3, checkpoint_interval=1, batch_size=1,
                           n_secs=0.5, n_epochs_early_stop=0,
                           validation_criteria_set="ToyMPE",
                           conv_backend="flax",
                           root_dir=str(tmp_path / "stop"))
    val_set = _train_set(ToyMPE, corpus, model.sliCQ, None)
    trainer = Trainer(model, loader, None, [val_set], config)
    trainer.run()
    assert trainer.batch_count == 1 and trainer.epoch_steps == 4
    assert set(threading.enumerate()) <= before


def test_model_learns_pitch(model):
    """After 60 ``"flax"`` steps of overfitting two pure tones, the
    transcription activations concentrate at the annotated bins (catches
    target misalignment and sign errors that shape tests miss)."""
    from timbre_trap_tpu_torch.data.pitch import PitchDataset

    m = model
    L, M = m.sliCQ.block_length, m.sliCQ.max_window_length
    t = np.arange(L) / SR
    freqs = [float(midi_to_hz(69.0)), float(midi_to_hz(72.0))]
    audio = np.stack([0.5 * np.sin(2 * np.pi * f * t) for f in freqs])
    audio = audio[:, None, :].astype(np.float32)
    gt = np.stack([
        PitchDataset.multi_pitch_to_activations(
            [np.array([f])] * M, m.sliCQ.get_midi_freqs())
        for f in freqs]).astype(np.float32)

    cfg = TrainConfig(multiplier_consistency=0.0)
    step = make_train_step(m, cfg, 2, conv_backend="flax")
    state = init_train_state(m, cfg)
    for _ in range(60):
        metrics = step(state, audio, gt, 2e-3)
    assert np.isfinite(float(metrics["loss/total"]))

    acts = m.transcribe(audio).numpy()
    bin_a = int(np.argmin(np.abs(m.sliCQ.midi_freqs - 69.0)))
    on = acts[0, bin_a].mean()
    off = np.delete(acts[0], slice(bin_a - 3, bin_a + 4), axis=0).mean()
    assert on > 0.5, f"GT-bin activation only {on:.3f}"
    assert on > 3 * off, f"no contrast: on={on:.3f} off={off:.3f}"


def test_skip_checkpoint_rebuilds_downstream(corpus, tmp_path):
    """A run trained with skip connections is consumable downstream without
    re-stating its configuration: the Trainer writes the run-level
    hparams.json and load_model rebuilds the trained model (skip weights
    and all) from the step checkpoint path alone."""
    skip_model = TimbreTrap(**HP, skip_connections=True, device="cpu")
    train_set = _train_set(ToyMPE, corpus, skip_model.sliCQ)
    val_set = _train_set(ToyMPE, corpus, skip_model.sliCQ, None)
    loader = DataLoader(train_set, batch_size=2, shuffle=True,
                        drop_last=True)
    config = TrainerConfig(max_epochs=1, checkpoint_interval=1, batch_size=2,
                           n_secs=0.5, learning_rate=1e-3,
                           validation_criteria_set="ToyMPE",
                           conv_backend="pallas",
                           root_dir=str(tmp_path / "skiprun"))
    trainer = Trainer(skip_model, loader, None, [val_set], config)
    trainer.run()

    models_dir = os.path.join(config.root_dir, "models")
    assert os.path.isfile(os.path.join(models_dir, "hparams.json"))
    ckpt = latest_checkpoint(models_dir)
    loaded = load_model(ckpt, overrides={"device": "cpu"})
    assert loaded.net.skip_connections
    assert {**loaded.hparams} == skip_model.hparams
    assert torch.equal(loaded.net.skip_weights, skip_model.net.skip_weights)
    results = evaluate(loaded, val_set, MULTIPLIERS)
    assert "mpe/f1-score" in results
